"""Task construction (port of ``repro/fl/tasks.py``): ``DataSpec`` +
``ModelSpec`` -> one ``Task`` with everything the runtime needs (initial
params, model dimension, grad_fn, per-round batch provider, eval_fn) plus
task constants.

A round's batch is the [K, B] example-INDEX tuple ``(idx,)``; ``grad_fn``
gathers the rows from the resident training arrays inside
``torch.func.grad``, as the reference does in its trace.  A chunk's batches
(``chunk_batch_provider(ts)``) are the [T, K, B] stack of those indices, made
on the host and copied to the device once.  ``mlp_task`` and
``ridge_task`` build a Task from given arrays, so the parity tests can hand
in the JAX package's data.

``build_task`` is cached on (data, model, K, device), as the reference's is
on (data, model, K): experiments and sweeps over one task share its arrays
and its ``grad_fn``, and with it the engines cached on that ``grad_fn``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.data.datasets import (FederatedSplit, device_batches,
                                       device_batches_many, ridge_data,
                                       split_dirichlet, split_iid,
                                       synthetic_mnist)
from repro_torch.fl.spec import DataSpec, ModelSpec
from repro_torch.models.simple import (init_mlp_classifier, init_ridge,
                                       mlp_classifier_accuracy,
                                       mlp_classifier_loss, ridge_constants,
                                       ridge_loss, ridge_optimum)

Tree = Dict[str, torch.Tensor]

# salts of the streams derived from DataSpec.seed: the data itself uses the
# seed's own generator, the split and the params init salted ones, and the
# per-round batches seed + 3 (the reference's layout)
_SPLIT_SALT = 1
_INIT_SALT = 2
_PROVIDER_OFFSET = 3


@dataclasses.dataclass
class Task:
    """Everything ``repro_torch.fed.runtime.run`` needs, built once."""

    params0: Tree
    model_dim: int
    grad_fn: Callable[[Tree, Any], Tree]
    batch_provider: Callable[[int], Any]
    chunk_batch_provider: Callable[[Sequence[int]], Any]
    eval_fn: Callable[[Tree], Dict[str, float]]
    constants: Dict[str, Any]


def _model_dim(params: Tree) -> int:
    return sum(int(v.numel()) for v in params.values())


def _providers(seed: int, split: FederatedSplit, batch_size: int, device):
    """The round's and the chunk's index-batch providers: one
    host-to-device copy each."""
    def provider(t):
        idx = device_batches(seed, split, batch_size, t)
        return (torch.as_tensor(idx, dtype=torch.int64, device=device),)

    def provider_chunk(ts):
        idx = device_batches_many(seed, split, batch_size, ts)
        return (torch.as_tensor(idx, dtype=torch.int64, device=device),)
    return provider, provider_chunk


def mlp_task(x_tr, y_tr, x_te, y_te, split: FederatedSplit, params0: Tree,
             *, batch_size: int, provider_seed: int, device) -> Task:
    """The Case-I classification task from given arrays (moved to
    ``device``)."""
    to = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)
    xd, yd = to(x_tr, torch.float32), to(y_tr, torch.int64)
    xe, ye = to(x_te, torch.float32), to(y_te, torch.int64)

    def loss_at(params, idx):
        return mlp_classifier_loss(params, xd[idx], yd[idx])

    def grad_fn(params, batch):
        (idx,) = batch
        return torch.func.grad(loss_at)(params, idx)

    @torch.no_grad()
    def eval_fn(params):
        return {
            "test_acc": float(mlp_classifier_accuracy(params, xe, ye)),
            "train_loss": float(mlp_classifier_loss(params, xd, yd)),
        }

    return Task(params0, _model_dim(params0), grad_fn,
                *_providers(provider_seed, split, batch_size, device),
                eval_fn, {"split": split})


def ridge_task(x, y, split: FederatedSplit, params0: Tree, *, lam: float,
               batch_size: int, provider_seed: int, device) -> Task:
    """The Case-II ridge task from given arrays (moved to ``device``); the
    constants L, M, f* are computed on the CPU."""
    xc = torch.tensor(np.asarray(x), dtype=torch.float32)
    yc = torch.tensor(np.asarray(y), dtype=torch.float32)
    L, M, _ = ridge_constants(xc, lam)
    w_star = ridge_optimum(xc, yc, lam)
    f_star = float(ridge_loss({"w": w_star}, xc, yc, lam))
    xd, yd = xc.to(device), yc.to(device)

    def loss_at(params, idx):
        return ridge_loss(params, xd[idx], yd[idx], lam)

    def grad_fn(params, batch):
        (idx,) = batch
        return torch.func.grad(loss_at)(params, idx)

    @torch.no_grad()
    def eval_fn(params):
        loss = float(ridge_loss(params, xd, yd, lam))
        return {"loss": loss, "gap": loss - f_star}

    return Task(params0, _model_dim(params0), grad_fn,
                *_providers(provider_seed, split, batch_size, device),
                eval_fn,
                {"split": split, "smoothness_L": L, "strong_convexity_M": M,
                 "f_star": f_star})


# sized for sweeps: a grid over data/model axes walks one entry per
# distinct (data, model, K, device), and an eviction drops the arrays and
# the grad_fn identity the engine caches key on
TASK_CACHE_SIZE = int(os.environ.get("REPRO_TASK_CACHE_SIZE", "32"))


def task_cache_info() -> Dict[str, int]:
    """``lru_cache`` statistics of ``build_task`` (hits mean shared arrays
    and warm engines across experiments and sweeps)."""
    return _build_task.cache_info()._asdict()


def build_task(data: DataSpec, model: ModelSpec, num_devices: int,
               device="cuda") -> Task:
    """Build (or fetch the cached) ``Task`` of a data/model spec pair on
    ``device``.  Every draw is made on a CPU generator first, so the task
    is the same on every device.  ``dirichlet`` splits of the ridge task
    fall back to IID (the task has no labels to skew by), through the
    cache, so both specs share one Task."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _build_task(data, model, num_devices, dev)


@functools.lru_cache(maxsize=TASK_CACHE_SIZE)
def _build_task(data: DataSpec, model: ModelSpec, num_devices: int,
                device: torch.device) -> Task:
    kind = model.resolve(data.dataset)
    gen = rng.generator(data.seed)
    split_gen = rng.generator(data.seed, _SPLIT_SALT)
    init_gen = rng.generator(data.seed, _INIT_SALT)
    provider_seed = data.seed + _PROVIDER_OFFSET
    if data.dataset == "synthetic_mnist":
        if kind != "mlp":
            raise ValueError(f"model kind {kind!r} cannot train on "
                             "synthetic_mnist (use 'mlp' or 'auto')")
        x, y = synthetic_mnist(gen, data.num_train + data.num_test)
        n = data.num_train
        if data.split == "iid":
            split = split_iid(split_gen, n, num_devices)
        else:
            split = split_dirichlet(split_gen, y[:n].numpy(), num_devices,
                                    data.alpha)
        params0 = init_mlp_classifier(init_gen, hidden=model.hidden,
                                      device=device)
        return mlp_task(x[:n], y[:n], x[n:], y[n:], split, params0,
                        batch_size=data.batch_size,
                        provider_seed=provider_seed, device=device)
    if kind != "ridge":
        raise ValueError(f"model kind {kind!r} cannot train on the ridge "
                         "task (use 'ridge' or 'auto')")
    if data.split == "dirichlet":
        return _build_task(dataclasses.replace(data, split="iid"), model,
                           num_devices, device)
    x, y, _ = ridge_data(gen, data.num_train, data.dim)
    split = split_iid(split_gen, data.num_train, num_devices)
    params0 = init_ridge(init_gen, data.dim, device=device)
    return ridge_task(x, y, split, params0, lam=model.lam,
                      batch_size=data.batch_size, provider_seed=provider_seed,
                      device=device)
