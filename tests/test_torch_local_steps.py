"""Local steps (``FLConfig.local_steps`` H > 1) in the port, on the CPU:
every device takes H SGD steps on its round batch and transmits
``(w_0 - w_H) / (H local_lr)``.  The port's rounds against the JAX
package's python-driver rounds (its batches, noise, masks and setup state
carried across), on the dense, the active-gather and the streamed round;
the scan driver against the python driver, bitwise; and H = 1 against the
round as it was before local steps existed, bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import schemes as jschemes
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.data.datasets import synthetic_mnist as jsynthetic_mnist
from repro.fed import runtime as jruntime
from repro.fl import DataSpec as JDataSpec
from repro.fl import ModelSpec as JModelSpec
from repro.fl.tasks import build_task as jbuild_task
from repro_torch import interop
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.datasets import FederatedSplit
from repro_torch.fed import runtime
from repro_torch.fl import (DataSpec, EvalSpec, Experiment, ExperimentSpec,
                            ModelSpec, tasks)

K = 8
ROUNDS = 3
LOCAL_LR = 0.05
DATA = dict(dataset="synthetic_mnist", split="dirichlet", alpha=1.0,
            batch_size=16, num_train=300, num_test=60, seed=0)
# port vs reference: H local steps of fp32 gradients, summed in other orders
# by XLA and PyTorch, compounded over the rounds (the runtime parity
# tolerance, tests/test_torch_runtime.py)
PARAMS_TOL = dict(rtol=1e-4, atol=1e-6)
HIST_TOL = dict(rel=1e-4, abs=1e-9)

# name -> (H, FLConfig overrides)
CASES = {
    "dense_h2": (2, {}),
    "dense_h4": (4, {}),
    "gather_h2": (2, dict(participation=0.5, participation_mode="fixed",
                          active_gather=True)),
    "k_block_h4": (4, dict(k_block=4)),
    "gather_k_block_h4": (4, dict(participation=0.5,
                                  participation_mode="fixed",
                                  active_gather=True, k_block=2)),
}


def _fl_kwargs(name):
    h, over = CASES[name]
    return dict(num_devices=K, scheme="normalized", case="I", p=0.75,
                smoothness_L=5.0, expected_loss_drop=2.0, seed=0,
                local_steps=h, local_lr=LOCAL_LR, **over)


@functools.lru_cache(maxsize=None)
def _jtask():
    return jbuild_task(JDataSpec(**DATA), JModelSpec(hidden=8), K)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's python-driver rounds of one case on its kernels
    backend, with the inputs the port needs: setup, batches, noise, masks,
    and each round's params and history."""
    task = _jtask()
    cfg = jruntime.FLConfig(
        backend="kernels",
        channel=JChannelConfig(num_devices=K, channel_mean=1e-3),
        **_fl_kwargs(name))
    state = jruntime.setup(cfg, task.params0, task.model_dim)
    setup = dict(params=jax.tree_util.tree_map(np.asarray, state.params),
                 h=state.h, h_hat=state.h_hat, b=state.b, a=state.a,
                 eta0=state.eta0, model_dim=state.model_dim)
    key = jax.random.PRNGKey(cfg.seed + 1)
    zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                                   task.params0)
    out = dict(noise={}, batches={}, masks={}, params=[], hist=[])
    for t in range(1, ROUNDS + 1):
        z, _ = ravel_pytree(jschemes.add_channel_noise(
            zeros, jax.random.fold_in(key, t), cfg.channel.noise_var))
        out["noise"][t] = np.array(z)
        out["batches"][t] = np.array(task.batch_provider(t)[0])
        if cfg.participation < 1.0:
            out["masks"][t] = np.array(jruntime._participation_mask(
                cfg, key, jnp.asarray(t)))
        state, h = jruntime.run(cfg, state, task.grad_fn,
                                task.batch_provider, 1, driver="python")
        out["params"].append(jax.tree_util.tree_map(np.array, state.params))
        out["hist"].append({k: h[k][0] for k in jruntime.DIAG_KEYS})
    return setup, out


def _port_task():
    jtask = _jtask()
    split = FederatedSplit(tuple(jtask.constants["split"].indices))
    params0 = interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtask.params0), device="cpu")
    n = DATA["num_train"]
    x, y = jsynthetic_mnist(jax.random.PRNGKey(DATA["seed"]),
                            n + DATA["num_test"])
    x, y = np.asarray(x), np.asarray(y)
    return tasks.mlp_task(x[:n], y[:n], x[n:], y[n:], split, params0,
                          batch_size=DATA["batch_size"], provider_seed=0,
                          device="cpu")


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("name", list(CASES))
def test_local_steps_match_reference(name, backend):
    setup, ref = _reference(name)
    cfg = runtime.FLConfig(
        backend=backend,
        channel=ChannelConfig(num_devices=K, channel_mean=1e-3),
        **_fl_kwargs(name))
    state = interop.state_from_jax(
        setup["params"], setup["h"], setup["h_hat"], setup["b"], setup["a"],
        setup["eta0"], 0, model_dim=setup["model_dim"], device="cpu")
    task = _port_task()
    masks = (dict(mask_provider=lambda t: torch.from_numpy(ref["masks"][t]))
             if ref["masks"] else {})
    for t in range(1, ROUNDS + 1):
        state, hist = runtime.run(
            cfg, state, task.grad_fn,
            lambda t: (torch.from_numpy(ref["batches"][t]),), 1,
            noise_provider=lambda t: torch.from_numpy(ref["noise"][t]),
            **masks)
        for k, want in ref["params"][t - 1].items():
            np.testing.assert_allclose(state.params[k].numpy(), want,
                                       **PARAMS_TOL,
                                       err_msg=f"{name} round {t} {k}")
        for k in runtime.DIAG_KEYS:
            assert hist[k][0] == pytest.approx(ref["hist"][t - 1][k],
                                               **HIST_TOL), (name, t, k)


def _spec(backend="kernels", **fl):
    return ExperimentSpec(
        fl=runtime.FLConfig(num_devices=K, backend=backend,
                            channel=ChannelConfig(num_devices=K,
                                                  channel_mean=1e-3),
                            smoothness_L=5.0, expected_loss_drop=2.0, **fl),
        data=DataSpec(num_train=200, num_test=50, batch_size=10),
        model=ModelSpec(hidden=8), eval=EvalSpec(every=3), chunk_size=2)


ROUNDS_OF = {"dense": {}, "gather": dict(participation=0.5,
                                         participation_mode="fixed",
                                         active_gather=True),
             "k_block": dict(k_block=2)}


def _same(a, b):
    assert a.history == b.history
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("round_", list(ROUNDS_OF))
def test_scan_is_bitwise_python_at_h4(round_, backend):
    runs = []
    for driver in ("scan", "python"):
        spec = _spec(local_steps=4, local_lr=LOCAL_LR, backend=backend,
                     **ROUNDS_OF[round_])
        e = Experiment(dataclasses.replace(spec, driver=driver),
                       device="cpu")
        e.run(5)
        runs.append(e)
    _same(*runs)
    assert runs[0].history["eval_round"] == [1, 3]


def _round_before_local_steps(cfg, grad_fn, params, batch):
    """The local computation as it was before local steps existed: every
    device's gradient, the params expanded along the device axis."""
    first = batch
    while not isinstance(first, torch.Tensor):
        first = first[0]
    per_device = {n: p.expand((first.shape[0],) + p.shape)
                  for n, p in params.items()}
    return torch.func.vmap(grad_fn, in_dims=(0, 0))(per_device, batch)


@pytest.mark.parametrize("round_", list(ROUNDS_OF))
def test_h1_is_the_round_before_local_steps(round_, monkeypatch):
    spec = _spec(**ROUNDS_OF[round_])
    new = Experiment(spec, device="cpu")
    new.run(4)
    monkeypatch.setattr(runtime, "_local_transmit",
                        _round_before_local_steps)
    old = Experiment(spec, device="cpu")
    old.run(4)
    _same(new, old)


def test_local_steps_transmit_the_average_step():
    """H steps of a ridge task by hand: the transmitted quantity is
    (w_0 - w_H) / (H lr), with the reference's fp32 order."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 4), generator=gen)
    y = torch.randn((3, 5), generator=gen)
    params = {"w": torch.randn((4,), generator=gen)}

    def grad_fn(p, batch):
        xb, yb = batch
        return {"w": xb.T @ (xb @ p["w"] - yb) / xb.shape[0]}

    cfg = runtime.FLConfig(num_devices=3, local_steps=3, local_lr=0.1)
    got = runtime._local_transmit(cfg, grad_fn, params, (x, y))["w"]
    for k in range(3):
        w = params["w"].clone()
        for _ in range(3):
            w = w - 0.1 * grad_fn({"w": w}, (x[k], y[k]))["w"]
        want = (params["w"] - w) * (1.0 / (3 * 0.1))
        # the port's products are batched over the devices, these are
        # not: the same fp32 terms in other orders
        torch.testing.assert_close(got[k], want, rtol=1e-6, atol=1e-6)
