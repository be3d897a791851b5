"""Run manifests (port of ``repro/obs/manifest.py``): the identity block a
result file carries -- the full spec as JSON, its config hash, the
structural signature (the sha-256 of the runtime's ``structural_config``:
equal signatures run on one engine), a params digest and the torch, CUDA and
GPU versions.

``params_sha256`` hashes the reference's exact byte format (per leaf, in
sorted-key order: the numpy dtype string, the shape string, the raw bytes),
so bitwise-equal params give the same digest in both packages.

The runtime import stays function-local: manifests are built on the host
path only.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

MANIFEST_VERSION = 1


def _sanitize(obj: Any) -> Any:
    """JSON-able view of nested dataclasses, tuples and numpy scalars."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _sanitize(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def spec_json(spec: Any) -> Dict[str, Any]:
    """The spec (an ``ExperimentSpec`` or a bare ``FLConfig``) as plain
    JSON-able nesting."""
    return _sanitize(spec)


def config_sha256(spec: Any) -> str:
    """sha-256 of the canonical (sorted-key) JSON dump of the spec: equal
    hashes mean equal declared experiments."""
    blob = json.dumps(spec_json(spec), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def _leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a params tree in the reference's flatten order (dict
    keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def params_sha256(params: Any) -> str:
    """Bitwise digest of a params tree (tensors or numpy arrays, on any
    device): dtype- and shape-tagged raw bytes of every leaf."""
    h = hashlib.sha256()
    for leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(leaf))
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def structural_signature(cfg: Any) -> str:
    """sha-256 of the runtime's structural collapse of ``cfg``: equal
    signatures run as lanes of one engine."""
    from repro_torch.fed import runtime

    return hashlib.sha256(
        repr(runtime.structural_config(cfg)).encode()).hexdigest()


def _device_identity() -> Dict[str, Any]:
    out: Dict[str, Any] = {"backend": "cpu", "local_devices": 0}
    if torch.cuda.is_available():
        out.update(backend="cuda", local_devices=torch.cuda.device_count(),
                   device_name=torch.cuda.get_device_name(0))
    return out


def run_manifest(spec: Any = None, cfg: Any = None, params: Any = None, *,
                 params_digest: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One manifest dict.  ``spec`` gives the spec JSON and config hash
    (and, through ``spec.fl_config()``, the structural signature when
    ``cfg`` is not given); ``params`` (or a ready ``params_digest``) the
    trajectory's digest; ``extra`` rides along verbatim."""
    out: Dict[str, Any] = {
        "manifest_version": MANIFEST_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "numpy_version": np.__version__,
        "python_version": platform.python_version(),
        "platform": platform.platform(),
        **_device_identity(),
    }
    if spec is not None:
        out["spec"] = spec_json(spec)
        out["config_sha256"] = config_sha256(spec)
        if cfg is None and hasattr(spec, "fl_config"):
            cfg = spec.fl_config()
    if cfg is not None:
        if spec is None:
            out["spec"] = spec_json(cfg)
            out["config_sha256"] = config_sha256(cfg)
        out["structural_signature"] = structural_signature(cfg)
    if params is not None:
        params_digest = params_sha256(params)
    if params_digest is not None:
        out["params_sha256"] = params_digest
    if extra:
        out.update(extra)
    return out
