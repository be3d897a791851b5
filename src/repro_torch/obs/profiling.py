"""Profiling hooks (port of ``repro/obs/profiling.py``): ``torch.profiler``
traces gated by ``REPRO_OBS_PROFILE``, and /proc RSS sampling.

Everything here is host-side and inert by default: with
``REPRO_OBS_PROFILE`` unset, ``start_profile`` returns None and
``annotate_chunk`` hands back a shared null context, so the engine's chunk
loop pays nothing.  Set it to a directory and every ``Experiment.run`` is
one ``torch.profiler`` trace (CPU activity, and CUDA activity where a card
is present, through CUPTI), written there as a Chrome trace
(``obs_trace_<pid>_<n>.json``, viewable in Perfetto), with one
``obs_chunk_<i>`` range per engine chunk.  A first ``run`` captures its
CUDA graph inside the trace; the replays' kernels show in the trace by
their names.

``rss_mb`` is the current resident set (``VmRSS``) that the ``chunk``
events carry; ``peak_rss_mb`` the process's peak (``VmHWM``, fresh at
exec, unlike the fork-inherited ``ru_maxrss``).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import resource
from typing import Optional

PROFILE_ENV = "REPRO_OBS_PROFILE"

_NULL_CTX = contextlib.nullcontext()
# one trace at a time: a nested run (a sweep's sequential fallback) does not
# start a second profiler
_ACTIVE = None
_TRACE_SEQ = itertools.count()


def profile_dir() -> Optional[str]:
    """The trace directory, or None when profiling is off."""
    return os.environ.get(PROFILE_ENV) or None


def enabled() -> bool:
    return profile_dir() is not None


def _proc_status_mb(field: str) -> Optional[float]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


def rss_mb() -> Optional[float]:
    """Current resident set (VmRSS) in MB; None without /proc."""
    return _proc_status_mb("VmRSS")


def peak_rss_mb() -> float:
    """This process's peak resident set in MB: ``VmHWM`` where /proc
    exists, else ``ru_maxrss``."""
    hwm = _proc_status_mb("VmHWM")
    if hwm is not None:
        return hwm
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def start_profile() -> Optional[str]:
    """Start a ``torch.profiler`` trace when ``REPRO_OBS_PROFILE`` names a
    directory and no trace is running.  Returns the directory as the handle
    for :func:`stop_profile`, else None."""
    global _ACTIVE
    out = profile_dir()
    if out is None or _ACTIVE is not None:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # one start/stop cycle a trace: accumulate its events (torch warns
    # otherwise that a cycle's end clears them)
    prof = profile(activities=activities, acc_events=True)
    prof.start()
    _ACTIVE = prof
    return out


def stop_profile(handle: Optional[str]) -> None:
    """End the trace that :func:`start_profile` started and write it into
    the directory (nothing for a None handle)."""
    global _ACTIVE
    if handle is None:
        return
    prof, _ACTIVE = _ACTIVE, None
    prof.stop()
    os.makedirs(handle, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        handle, f"obs_trace_{os.getpid()}_{next(_TRACE_SEQ)}.json"))


def annotate_chunk(index: int):
    """A ``record_function`` range ``obs_chunk_<index>`` around one engine
    chunk while profiling is on; the shared null context when it is
    off."""
    if not enabled():
        return _NULL_CTX
    import torch

    return torch.profiler.record_function(f"obs_chunk_{int(index)}")
