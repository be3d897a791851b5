"""The built-in telemetry sinks (port of ``repro/obs/recorders.py``):
in-memory, JSONL event log, CSV, null.

All four take the event schema of :mod:`repro_torch.obs.base` and differ
only in where events land.  Importing ``repro_torch.obs`` registers them::

    rec = obs.make("jsonl", path="results/run.jsonl")
    experiment.run(300, recorder=rec)
    rec.close()
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, List, Optional

from .base import Recorder, register


class NullRecorder(Recorder):
    """Discards every event: the cost of a recorder with no sink."""

    name = "null"

    def emit(self, event: Dict[str, Any]) -> None:
        pass


class MemoryRecorder(Recorder):
    """Keeps every event in ``self.events`` and the latest of each kind:
    the sink behind ``repro_torch.launch.serve.serve_metrics`` and the
    parity tests."""

    name = "memory"

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self._latest: Dict[str, Optional[Dict[str, Any]]] = {
            "manifest": None, "round": None, "eval": None, "chunk": None}

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)
        kind = event.get("event")
        if kind in self._latest:
            self._latest[kind] = event

    def latest(self) -> Dict[str, Any]:
        """The most recent ``round`` / ``eval`` / ``chunk`` / ``manifest``
        events and the event count (what the metrics endpoint serves)."""
        return {"events": len(self.events), **self._latest}

    def select(self, kind: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("event") == kind]


class JsonlRecorder(Recorder):
    """One JSON line per event, buffered and written ``flush_every`` lines
    at a time, so the per-chunk events cost the host no file write a
    chunk."""

    name = "jsonl"

    def __init__(self, path: str, flush_every: int = 256) -> None:
        self.path = path
        self._flush_every = max(int(flush_every), 1)
        self._buf: List[str] = []
        self._file = open(path, "w")

    def emit(self, event: Dict[str, Any]) -> None:
        self._buf.append(json.dumps(event, default=str))
        if len(self._buf) >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._file.write("\n".join(self._buf) + "\n")
            self._buf = []
        self._file.flush()

    def close(self) -> None:
        self.flush()
        self._file.close()


class CsvRecorder(Recorder):
    """One CSV row per ``round`` event, the columns fixed by the first row
    (``round`` and the ``DIAG_KEYS``); other events are dropped (the JSONL
    log is the faithful sink)."""

    name = "csv"

    def __init__(self, path: str) -> None:
        self.path = path
        self._file = open(path, "w", newline="")
        self._writer: Optional[csv.DictWriter] = None

    def emit(self, event: Dict[str, Any]) -> None:
        if event.get("event") != "round":
            return
        row = {k: (json.dumps(v) if isinstance(v, list) else v)
               for k, v in event.items() if k != "event"}
        if self._writer is None:
            self._writer = csv.DictWriter(self._file, fieldnames=list(row))
            self._writer.writeheader()
        self._writer.writerow(row)

    def close(self) -> None:
        self._file.flush()
        self._file.close()


register("null", NullRecorder)
register("memory", MemoryRecorder)
register("jsonl", JsonlRecorder)
register("csv", CsvRecorder)
