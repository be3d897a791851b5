"""Recorder registry and event model of the flight recorder (port of
``repro/obs/base.py``).

Every telemetry sink is one factory in a module-level registry, looked up
by name (``make("jsonl", path=...)``), so the engine stays agnostic of where
events land.

The contract every sink inherits: telemetry is **trajectory-invisible**.  A
:class:`Recorder` only sees host values the engine already has at a chunk
boundary (the chunk's [T, 8] history after ``engine.rows()`` copied it to
the host, the eval metrics, wall clock), never a device buffer, a staged
input or the captured round, so recorder on against off, and any sink, give
the same bits in params, client state and history.
``tests/test_torch_isolation.py`` holds the static half: ``RoundBody`` and
the round functions it calls name no recorder.

Event schema (one JSON-able dict per event; the JSONL sink writes one line
per event, and ``Experiment.dump_history`` writes the same ``round`` and
``eval`` lines afterwards):

* ``{"event": "manifest", "manifest": {...}}``: the run's identity (see
  :mod:`repro_torch.obs.manifest`), once at the start of a run;
* ``{"event": "round", "round": t, "<diag>": v, ...}``: one round's
  ``DIAG_KEYS`` values; ``v`` a float (``run``) or an [E] list
  (``run_batched``: one value a lane);
* ``{"event": "eval", "round": t, "<metric>": v, ...}``: the eval metrics
  at an eval round, the same scalar or list convention;
* ``{"event": "chunk", "chunk": i, "round_start": .., "round_end": ..,
  "wall_time_s": .., "dispatches": .., "retraces": {kind: delta},
  "rss_mb": ..}``: one engine chunk: its wall clock, the round launches it
  queued (CUDA-graph replays on the card), the build and capture deltas per
  ``runtime.TRACE_KINDS`` builder, and the host's resident set.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np


def _round_value(values: Any, j: int) -> Any:
    """The round-``j`` slice of one diagnostic: a float for a [T] series,
    an [E] list for a batched [E, T] series."""
    arr = np.asarray(values)
    if arr.ndim <= 1:
        return float(arr[j]) if arr.ndim == 1 else float(arr)
    return [float(x) for x in arr[:, j]]


def _scalar_or_list(v: Any) -> Any:
    arr = np.asarray(v)
    return float(arr) if arr.ndim == 0 else [float(x) for x in arr]


class Recorder:
    """Base telemetry sink: subclasses implement :meth:`emit` (one host-side
    event dict); the ``on_*`` helpers build the event schema so every sink
    agrees on it.  Recorders are context managers (``close`` on exit) and
    may be reused across runs: events keep appending."""

    name = "base"

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Flush and release the sink (nothing by default)."""

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def on_manifest(self, manifest: Mapping[str, Any]) -> None:
        self.emit({"event": "manifest", "manifest": dict(manifest)})

    def on_round(self, t: int, diag_row: Mapping[str, Any]) -> None:
        event: Dict[str, Any] = {"event": "round", "round": int(t)}
        for k, v in diag_row.items():
            event[k] = _scalar_or_list(v)
        self.emit(event)

    def on_chunk(self, index: int, ts: Sequence[int],
                 diag: Mapping[str, Any], *,
                 wall_time_s: Optional[float] = None, dispatches: int = 1,
                 retraces: Optional[Mapping[str, int]] = None,
                 rss_mb: Optional[float] = None) -> None:
        """One engine chunk: the chunk event, then one ``round`` event per
        round of ``ts`` (``diag`` maps each diagnostic to its [T], or
        batched [E, T], chunk series)."""
        self.emit({
            "event": "chunk", "chunk": int(index),
            "round_start": int(ts[0]), "round_end": int(ts[-1]),
            "wall_time_s": wall_time_s, "dispatches": int(dispatches),
            "retraces": dict(retraces or {}), "rss_mb": rss_mb,
        })
        for j, t in enumerate(ts):
            self.on_round(int(t), {k: _round_value(v, j)
                                   for k, v in diag.items()})

    def on_eval(self, t: int, metrics: Mapping[str, Any]) -> None:
        event: Dict[str, Any] = {"event": "eval", "round": int(t)}
        for k, v in metrics.items():
            event[k] = _scalar_or_list(v)
        self.emit(event)


_REGISTRY: Dict[str, Callable[..., Recorder]] = {}


def register(name: str, factory: Callable[..., Recorder]) -> None:
    if not callable(factory):
        raise TypeError(f"recorder factory for {name!r} must be callable")
    _REGISTRY[name] = factory


def get(name: str) -> Callable[..., Recorder]:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(names())
        raise KeyError(f"unknown recorder {name!r}; known: {known}")


def names() -> List[str]:
    return sorted(_REGISTRY)


def make(name: str, **kwargs) -> Recorder:
    """Instantiate a registered sink: ``make("jsonl", path="run.jsonl")``."""
    return get(name)(**kwargs)
