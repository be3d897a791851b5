"""Server-side optimizers (port of ``repro/optim/optimizers.py``): SGD with
momentum and AdamW, on ``dict[str, Tensor]`` parameters.

``update(grads, state, params, lr=None) -> (new_params, new_state)``; ``lr``
overrides the constructor's rate for that call: a float, or a 0-d fp32
tensor on the params' device (the FL runtime passes the paper's eta_t so,
read from device memory by a CUDA graph of the round).  Updates are
functional: new tensors, inputs untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


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
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _scalar_zero(params: Params, dtype=torch.float32) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=dtype, device=dev)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    base_lr = lr

    def init(params):
        mu = _zeros_like(params) if momentum else _scalar_zero(params)
        return OptState(_scalar_zero(params, torch.int32), mu,
                        _scalar_zero(params))

    def update(grads, state, params, lr=None):
        eta = base_lr if lr is None else lr
        step = state.step + 1
        if momentum:
            mu = {k: momentum * state.mu[k] + grads[k] for k in params}
            upd = mu
        else:
            mu = state.mu
            upd = grads
        new = {k: params[k] - (eta * upd[k]).to(params[k].dtype)
               for k in params}
        return new, OptState(step, mu, state.nu)

    return Optimizer(init, update, "sgd")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    base_lr = lr

    def init(params):
        return OptState(_scalar_zero(params, torch.int32), _zeros_like(params),
                        _zeros_like(params))

    def update(grads, state, params, lr=None):
        eta = base_lr if lr is None else lr
        step = state.step + 1
        t = step.float()
        mu = {k: b1 * state.mu[k] + (1 - b1) * grads[k].to(state.mu[k].dtype)
              for k in params}
        nu = {k: b2 * state.nu[k]
              + (1 - b2) * torch.square(grads[k].to(state.nu[k].dtype))
              for k in params}
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        new = {}
        for k, p in params.items():
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p
            new[k] = p - (eta * u).to(p.dtype)
        return new, OptState(step, mu, nu)

    return Optimizer(init, update, "adamw")
