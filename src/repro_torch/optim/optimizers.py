"""Optimizers and the paper's learning-rate schedules (port of
``repro/optim/optimizers.py``): SGD with momentum and AdamW over any tree
of tensors -- the FL runtime's flat ``dict[str, Tensor]`` or a model's
nested dicts and tuples.

``update(grads, state, params, lr=None) -> (new_params, new_state)``.  The
constructor's ``lr`` is a float or a schedule ``step -> eta`` (a 0-d fp32
tensor), evaluated at the incremented step, as in the reference.  A
per-call ``lr`` overrides it: a float, or a 0-d fp32 tensor on the params'
device (the FL runtime passes the paper's eta_t so, read from device memory
by a CUDA graph of the round).  Updates are functional: new tensors,
inputs untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any            # a tree of tensors: dicts, tuples and lists
Schedule = Callable[[torch.Tensor], torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any                 # first moment / momentum (or a zero scalar)
    nu: Any                 # second moment (Adam only)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[..., Tuple[Params, OptState]]
    name: str = "sgd"


def _zeros_like(params: Params) -> Params:
    return tree_map(torch.zeros_like, params)


def _scalar_zero(params: Params, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=tree_leaves(params)[0].device)


def _rate(lr: Union[float, Schedule]) -> Callable:
    """``step -> eta`` of a constructor's ``lr``: the schedule itself, or
    the float (kept a python float, so a constant rate multiplies as the
    port always did)."""
    return lr if callable(lr) else (lambda _: lr)


def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        mu = _zeros_like(params) if momentum else _scalar_zero(params)
        return OptState(_scalar_zero(params, torch.int32), mu,
                        _scalar_zero(params))

    def update(grads, state, params, lr=None):
        step = state.step + 1
        eta = lr_fn(step) if lr is None else lr
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
            upd = mu
        else:
            mu = state.mu
            upd = grads
        new = tree_map(lambda p, u: p - (eta * u).to(p.dtype), params, upd)
        return new, OptState(step, mu, state.nu)

    return Optimizer(init, update, "sgd")


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        return OptState(_scalar_zero(params, torch.int32), _zeros_like(params),
                        _zeros_like(params))

    def update(grads, state, params, lr=None):
        step = state.step + 1
        eta = lr_fn(step) if lr is None else lr
        t = step.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                      * torch.square(g.to(v.dtype)), state.nu, grads)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return p - (eta * u).to(p.dtype)

        return tree_map(upd, params, mu, nu), OptState(step, mu, nu)

    return Optimizer(init, update, "adamw")


# ---------------------------------------------------------------------------
# schedules: step (an int32 tensor) -> eta (a 0-d fp32 tensor on its device)


def inverse_power_schedule(p: float, eta0: float = 1.0) -> Schedule:
    """The paper's Case-I schedule: eta_t = eta0 / t^p, 1/2 < p < 1."""
    if not (0.5 < p < 1.0):
        raise ValueError("p must lie in (1/2, 1)")

    def sched(step):
        t = torch.clamp(torch.as_tensor(step).float(), min=1.0)
        return eta0 / t ** p

    return sched


def constant_schedule(eta: float) -> Schedule:
    """The paper's Case-II schedule: eta_t = eta."""
    return lambda step: torch.full((), eta, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Schedule:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    decay to ``floor`` at ``total``."""
    def sched(step):
        t = torch.as_tensor(step).float()
        warm = peak * t / max(warmup, 1)
        prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(t < warmup, warm, cos)

    return sched
