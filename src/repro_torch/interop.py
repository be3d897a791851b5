"""Carry the JAX package's arrays across to the port (numpy in, torch out),
so both packages compute the same thing in the parity tests.

Takes numpy arrays (``np.asarray`` of JAX arrays), never JAX objects: this
module, like the rest of the port, imports no ``jax``.  Parameter trees are
flat dicts; the port orders their leaves by sorted key, as ``jax.tree_util``
orders a dict.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.fed.runtime import FLState


def params_from_jax(tree: Mapping[str, Any], device="cpu"
                    ) -> dict:
    """A flat ``{name: array}`` tree -> ``{name: Tensor}`` on ``device``
    (dtype kept)."""
    return {k: torch.as_tensor(np.array(tree[k])).to(device)
            for k in sorted(tree)}


def state_from_jax(params: Mapping[str, Any], h, h_hat, b, a, eta0,
                   round: int = 0, *, model_dim: int = 0,
                   device="cpu") -> FLState:
    """An ``FLState`` holding the reference's parameters and channel state
    (``h``, ``h_hat``, ``b`` as float64 [K]; ``a``, ``eta0`` floats)."""
    h = np.asarray(h, np.float64)
    return FLState(params=params_from_jax(params, device),
                   h=h, b=np.asarray(b, np.float64), a=float(a),
                   eta0=float(eta0), round=int(round), model_dim=model_dim,
                   h_hat=h if h_hat is None else np.asarray(h_hat,
                                                            np.float64))
