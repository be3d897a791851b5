"""Checkpoints (port of ``repro/checkpoint/store.py``): a tree of tensors and
numpy arrays as MessagePack, in the reference's file format, so a file
either package writes restores in the other.

The payload is ``{"meta": {...}, "leaves": {path: {"dtype", "shape",
"data", "orig_dtype"}}}``: each leaf keyed by its path as
``jax.tree_util.keystr`` spells it (``['params']['w1']``, ``['opt'].mu``,
``['t'][0]``) and stored as the numpy dtype string, the shape and the raw
C-order bytes; bfloat16 is stored as float32 with ``orig_dtype`` set.  The
flattening is jax's: a dict's keys sorted, a NamedTuple's fields (``.name``)
and a tuple's or list's items (``[i]``) in order, and a ``None`` has no
leaf.  Writes are atomic (a ``.tmp`` file, then ``os.replace``);
``save_round`` keeps the latest k.  The MessagePack codec is the port's own
(``_msgpack``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

Tree = Any


def _flatten_with_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in jax's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name, v in zip(tree._fields, tree)
                for pair in _flatten_with_paths(v, f"{prefix}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like: Tree, values: Dict[str, Any], prefix: str = "") -> Tree:
    """``like`` with each leaf replaced by ``values[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, values, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, values, f"{prefix}.{name}")
                            for name, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, values, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    return values[prefix]


def _encode_array(a) -> Dict[str, Any]:
    orig = None
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            orig, a = "bfloat16", a.float()
        a = a.cpu().numpy()
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name not in np.sctypeDict:
        # bfloat16 and friends as numpy extension types
        orig, a = str(a.dtype), a.astype(np.float32)
    return {"dtype": a.dtype.str, "shape": [int(s) for s in a.shape],
            "data": np.ascontiguousarray(a).tobytes(), "orig_dtype": orig}


def _decode_array(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def save(path: str, tree: Tree, metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (tensors on any device, numpy arrays) and
    ``metadata`` to ``path``."""
    payload = {
        "meta": metadata or {},
        "leaves": {k: _encode_array(v)
                   for k, v in _flatten_with_paths(tree)},
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(payload))
    os.replace(tmp, path)


def restore(path: str, like: Tree,
            missing_ok: Tuple[str, ...] = ()) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``like`` (shapes checked); returns
    ``(tree, metadata)``.

    A numpy leaf of ``like`` comes back as numpy in its own dtype (the
    float64 channel must not pass through fp32); a tensor leaf as a tensor
    of ``like``'s dtype on ``like``'s device.  Leaves under a prefix of
    ``missing_ok`` (keystr form, e.g. ``"['channel']['h_hat']"``) may be
    absent from the file and keep ``like``'s value; any other absent leaf
    raises ``KeyError``.  Stored leaves that ``like`` lacks are ignored."""
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    stored = payload["leaves"]
    out = {}
    for k, ref in _flatten_with_paths(like):
        if k not in stored:
            if any(k.startswith(p) for p in missing_ok):
                out[k] = ref
                continue
            raise KeyError(f"checkpoint missing leaf {k}")
        arr = _decode_array(stored[k])
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"shape mismatch at {k}: {arr.shape} vs "
                             f"{tuple(np.shape(ref))}")
        if isinstance(ref, torch.Tensor):
            out[k] = torch.from_numpy(arr).to(device=ref.device,
                                              dtype=ref.dtype)
        else:
            out[k] = arr.astype(np.asarray(ref).dtype)
    return _unflatten(like, out), payload["meta"]


def save_round(ckpt_dir: str, round_idx: int, tree: Tree,
               metadata: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``round_<idx>.msgpack`` into ``ckpt_dir`` (``round`` added to
    the metadata) and delete all but the latest ``keep``."""
    path = os.path.join(ckpt_dir, f"round_{round_idx:08d}.msgpack")
    meta = dict(metadata or {})
    meta["round"] = round_idx
    save(path, tree, meta)
    existing = sorted(p for p in os.listdir(ckpt_dir)
                      if p.startswith("round_"))
    for old in existing[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def latest_round(ckpt_dir: str) -> Optional[str]:
    """The newest ``round_*`` file of ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    existing = sorted(p for p in os.listdir(ckpt_dir)
                      if p.startswith("round_"))
    return os.path.join(ckpt_dir, existing[-1]) if existing else None
