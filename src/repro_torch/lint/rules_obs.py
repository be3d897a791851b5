"""TL009: the flight recorder stays out of the captured round.

``repro_torch.obs`` is host-side by contract: recorders only see values the
engine already copied to the host at a chunk boundary (``_emit_chunk`` and
``run``), which is what makes telemetry trajectory-invisible (recorder on
vs off bitwise; ``tests/test_torch_obs.py``).  An obs call inside the
captured round would be recorded once into the CUDA graph and never again,
or add a host sync to every round.  No call into ``repro_torch.obs``, no
``profiling.`` call and no recorder method may appear in the round.
"""
from __future__ import annotations

import ast
from typing import List

from .base import Finding, Rule, register
from .context import dotted, find_captured

# a dotted call with one of these segments is an obs call: obs.make(...),
# profiling.annotate_chunk(...), repro_torch.obs.manifest.params_sha256(...)
_OBS_SEGMENTS = {"obs", "profiling", "obsprof"}
# recorder-protocol methods, on a conventionally named recorder
_RECORDER_METHODS = {"emit", "flush", "close", "latest", "select",
                     "on_manifest", "on_round", "on_chunk", "on_eval"}
_RECORDER_NAMES = {"recorder", "rec", "sink"}


def _tl009(project) -> List[Finding]:
    cap = find_captured(project)
    findings: List[Finding] = []
    seen = set()
    bodies = [(mod, fn) for mod, fn in cap.functions] + list(cap.lambdas)
    for mod, body in bodies:
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted(node.func)
            msg = None
            if fn and _OBS_SEGMENTS.intersection(fn.split(".")):
                msg = (f"`{fn}` (repro_torch.obs) called inside the captured "
                       "round; telemetry is host-side only -- emit at the "
                       "chunk boundary after the replays")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _RECORDER_METHODS
                  and dotted(node.func.value).rsplit(".", 1)[-1]
                  in _RECORDER_NAMES):
                msg = (f"recorder method `.{node.func.attr}()` called inside "
                       "the captured round; recorders only consume host "
                       "values at chunk boundaries")
            key = (mod.relpath, node.lineno, msg)
            if msg is not None and key not in seen:
                seen.add(key)
                findings.append(Finding("TL009", mod.relpath, node.lineno,
                                        msg))
    return findings


register(Rule(
    id="TL009", name="obs-in-captured-round",
    summary="repro_torch.obs / profiling / recorder call inside the captured "
            "round",
    contract="the flight recorder's trajectory invisibility "
             "(tests/test_torch_obs.py)",
    check=_tl009))
