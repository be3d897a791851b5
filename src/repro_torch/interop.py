"""Carry the JAX package's arrays across to the port (numpy in, torch out),
so both packages compute the same thing in the parity tests.

Takes numpy arrays (``np.asarray`` of JAX arrays), never JAX objects: this
module, like the rest of the port, imports no ``jax``.  The FL models'
parameter trees are flat dicts; the port orders their leaves by sorted key,
as ``jax.tree_util`` orders a dict.  The model zoo's trees are nested dicts
and tuples (``model_params_from_jax``).  Every function here puts its
tensors on the card unless the caller passes ``device="cpu"`` (the tests),
and raises without a card, as ``resolve_device`` does.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fed.runtime import FLState
from repro_torch.optim.optimizers import OptState


def params_from_jax(tree: Mapping[str, Any], device="cuda"
                    ) -> dict:
    """A flat ``{name: array}`` tree -> ``{name: Tensor}`` on ``device``
    (dtype kept)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(tree[k])).to(dev)
            for k in sorted(tree)}


def _opt_state_from_jax(opt_state, device) -> OptState:
    """The reference's ``OptState(step, mu, nu)`` (numpy leaves; ``mu`` and
    ``nu`` flat trees or 0-d arrays) -> the port's, on ``device``."""
    dev = resolve_device(device)

    def part(v):
        if isinstance(v, Mapping):
            return params_from_jax(v, dev)
        return torch.as_tensor(np.array(v)).to(dev)
    step, mu, nu = opt_state
    return OptState(part(step), part(mu), part(nu))


def state_from_jax(params: Mapping[str, Any], h, h_hat, b, a, eta0,
                   round: int = 0, *, model_dim: int = 0, fad_state=None,
                   scale=None, client_state=None, opt_state=None,
                   device="cuda") -> FLState:
    """An ``FLState`` holding the reference's parameters and channel state
    (``h``, ``h_hat``, ``b`` as float64 [K]; ``a``, ``eta0`` floats; the
    AR(1) model's [K, 2] ``fad_state`` and the geometry's [K] ``scale``
    as float64, or None), its client state (``{"dev": tree or None,
    "srv": tree or None}`` of arrays, or None) and its server optimizer's
    state (``OptState(step, mu, nu)`` of arrays, or None for a state
    before its first run), so a state from the reference's ``setup()`` or
    ``run()`` runs in the port."""
    h = np.asarray(h, np.float64)
    as64 = lambda v: None if v is None else np.asarray(v, np.float64)
    return FLState(params=params_from_jax(params, device),
                   h=h, b=np.asarray(b, np.float64), a=float(a),
                   eta0=float(eta0), round=int(round), model_dim=model_dim,
                   h_hat=h if h_hat is None else as64(h_hat),
                   fad_state=as64(fad_state), scale=as64(scale),
                   opt_state=(None if opt_state is None
                              else _opt_state_from_jax(opt_state, device)),
                   client_state=None if client_state is None else {
                       part: None if tree is None
                       else params_from_jax(tree, device)
                       for part, tree in client_state.items()})


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, as JAX gives it
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a)).to(device)


def model_params_from_jax(tree, device="cuda"):
    """A model zoo parameter tree (nested dicts and tuples of numpy arrays:
    ``jax.tree_util.tree_map(np.asarray, params)``) -> the same tree of
    tensors on ``device``, dtype kept (bfloat16 included)."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: model_params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(model_params_from_jax(v, device) for v in tree)
    return _tensor(tree, device)
