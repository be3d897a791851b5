"""Partial participation in the port, on the CPU: ``bernoulli`` and
``fixed`` masks on the dense and the streaming round against the JAX
package's rounds (its masks injected through ``run(mask_provider=)``, and a
round in which nobody participates), ``active_gather`` with ``k_block``, and
the port's own contracts: the active-set gather is bitwise the dense masked
round, and the mask does not depend on the blocking.
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
from repro_torch.core import ota
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.datasets import FederatedSplit
from repro_torch.fed import runtime
from repro_torch.fl import (DataSpec, EvalSpec, Experiment, ExperimentSpec,
                            ModelSpec, tasks)

K = 12
ROUNDS = 4
EMPTY_ROUND = 2
DATA = dict(dataset="synthetic_mnist", split="dirichlet", alpha=1.0,
            batch_size=16, num_train=300, num_test=60, seed=0)
# streamed vs dense, and port vs reference over several rounds (the
# reference's STREAM_TOL, tests/test_streaming.py)
STREAM_TOL = dict(rtol=3e-4, atol=1e-6)

# (mode, participation, k_block, active_gather); the bernoulli cases use a
# participation no other test uses, so the reference compiles them afresh
# with the empty round patched in
CASES = {
    "bernoulli_dense": ("bernoulli", 0.55, None, False),
    "bernoulli_streamed": ("bernoulli", 0.55, 4, False),
    "fixed_dense": ("fixed", 0.5, None, False),
    "fixed_gather_streamed": ("fixed", 0.5, 3, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fl_kwargs(mode, p, k_block, gather):
    return dict(num_devices=K, scheme="normalized", case="I", p=0.75,
                smoothness_L=5.0, expected_loss_drop=2.0, seed=0,
                participation=p, participation_mode=mode, k_block=k_block,
                active_gather=gather)


@functools.lru_cache(maxsize=None)
def _jtask():
    return jbuild_task(JDataSpec(**DATA), JModelSpec(hidden=8), K)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's python-driver rounds of one case on its kernels
    backend; bernoulli rounds have round EMPTY_ROUND's mask zeroed (the
    reference's own test idiom: its mask draw is patched).  Returns the
    setup, per-round batches, noise, masks, params and history."""
    mode, p, kb, gather = CASES[name]
    task = _jtask()
    cfg = jruntime.FLConfig(
        backend="kernels",
        channel=JChannelConfig(num_devices=K, channel_mean=1e-3),
        **_fl_kwargs(mode, p, kb, gather))
    draw = jruntime._participation_mask

    def masked(cfg_, key, t):
        m = draw(cfg_, key, t)
        if mode == "bernoulli":
            m = jnp.where(t == EMPTY_ROUND, jnp.zeros_like(m), m)
        return m

    state = jruntime.setup(cfg, task.params0, task.model_dim)
    setup = dict(params=jax.tree_util.tree_map(np.asarray, state.params),
                 h=state.h, h_hat=state.h_hat, b=state.b, a=state.a,
                 eta0=state.eta0, model_dim=state.model_dim)
    key = jax.random.PRNGKey(cfg.seed + 1)
    zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                                   task.params0)
    out = dict(noise={}, batches={}, masks={}, params=[], hist=[])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "_participation_mask", masked)
        for t in range(1, ROUNDS + 1):
            z, _ = ravel_pytree(jschemes.add_channel_noise(
                zeros, jax.random.fold_in(key, t), cfg.channel.noise_var))
            out["noise"][t] = np.array(z)
            out["batches"][t] = np.array(task.batch_provider(t)[0])
            out["masks"][t] = np.array(masked(cfg, key, jnp.asarray(t)))
            state, h = jruntime.run(cfg, state, task.grad_fn,
                                    task.batch_provider, 1, driver="python")
            out["params"].append(jax.tree_util.tree_map(np.array,
                                                        state.params))
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
def test_masked_rounds_match_reference(name, backend):
    setup, ref = _reference(name)
    mode, p, kb, gather = CASES[name]
    cfg = runtime.FLConfig(
        backend=backend,
        channel=ChannelConfig(num_devices=K, channel_mean=1e-3),
        **_fl_kwargs(mode, p, kb, gather))
    state = interop.state_from_jax(
        setup["params"], setup["h"], setup["h_hat"], setup["b"], setup["a"],
        setup["eta0"], 0, model_dim=setup["model_dim"], device="cpu")
    task = _port_task()
    prev = {k: v.clone() for k, v in state.params.items()}
    for t in range(1, ROUNDS + 1):
        state, hist = runtime.run(
            cfg, state, task.grad_fn,
            lambda t: (torch.from_numpy(ref["batches"][t]),), 1,
            noise_provider=lambda t: torch.from_numpy(ref["noise"][t]),
            mask_provider=lambda t: torch.from_numpy(ref["masks"][t]))
        for k, want in ref["params"][t - 1].items():
            np.testing.assert_allclose(state.params[k].numpy(), want,
                                       **STREAM_TOL,
                                       err_msg=f"{name} round {t} {k}")
        want_hist = ref["hist"][t - 1]
        # the participant count is exact; the rest are fp32 sums of the
        # same per-device terms in other orders
        assert hist["num_participants"][0] == want_hist["num_participants"]
        for k in runtime.DIAG_KEYS:
            assert hist[k][0] == pytest.approx(want_hist[k], rel=1e-4,
                                               abs=1e-9), (name, t, k)
        if mode == "bernoulli" and t == EMPTY_ROUND:
            # nobody transmitted: the reference applies no update
            assert hist["num_participants"] == [0.0]
            assert hist["update_norm"] == [0.0]
            for k in prev:
                assert torch.equal(state.params[k], prev[k]), k
        prev = {k: v.clone() for k, v in state.params.items()}


@pytest.mark.parametrize("k_block", [None, 4])
def test_empty_round_is_a_true_noop(k_block):
    """A round in which nobody transmits leaves params and the server
    optimizer state untouched, even for a stateful optimizer (adam moments
    and weight decay would move them otherwise), on the dense and the
    streamed round (the reference's tests/test_engine.py contract)."""
    cfg = runtime.FLConfig(
        num_devices=8, channel=ChannelConfig(num_devices=8,
                                             channel_mean=1e-3),
        smoothness_L=5.0, expected_loss_drop=2.0, server_opt="adamw",
        server_weight_decay=0.1, participation=0.5, k_block=k_block)
    spec = _tiny_spec()
    task = tasks.build_task(spec.data, spec.model, 8, "cpu")
    state = runtime.setup(cfg, task.params0, task.model_dim)
    params0 = {k: v.clone() for k, v in state.params.items()}
    state, hist = runtime.run(cfg, state, task.grad_fn, task.batch_provider,
                              2, mask_provider=lambda t: torch.zeros(8))
    for k in params0:
        assert torch.equal(state.params[k], params0[k]), k
    assert int(state.opt_state.step) == 0
    for k, mu in state.opt_state.mu.items():
        assert torch.equal(mu, torch.zeros_like(mu)), k
    assert hist["update_norm"] == [0.0, 0.0]
    assert hist["num_participants"] == [0.0, 0.0]
    assert hist["tx_energy"] == [0.0, 0.0]


def _tiny_spec(**fl):
    return ExperimentSpec(
        fl=runtime.FLConfig(num_devices=8, channel=ChannelConfig(
            num_devices=8, channel_mean=1e-3), smoothness_L=5.0,
            expected_loss_drop=2.0, **fl),
        data=DataSpec(num_train=200, num_test=50, batch_size=10),
        model=ModelSpec(hidden=8), eval=EvalSpec(every=2))


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("scheme", ["normalized", "benchmark2", "mean"])
def test_active_gather_is_bitwise_the_dense_masked_round(scheme, backend):
    """Only the scheduled devices compute gradients, yet params and the
    participant count are bitwise the dense masked round's (a masked
    device's terms are exact zeros either way)."""
    kw = dict(backend=backend, scheme=scheme, participation=0.5,
              participation_mode="fixed")
    dense = Experiment(_tiny_spec(**kw), device="cpu")
    dense.run(4)
    gather = Experiment(_tiny_spec(active_gather=True, **kw), device="cpu")
    gather.run(4)
    for k in dense.params:
        assert torch.equal(gather.params[k], dense.params[k]), k
    assert gather.history["num_participants"] == [4.0] * 4
    assert (gather.history["num_participants"]
            == dense.history["num_participants"])
    # eq.-8 energies: the same terms, summed over [m] rows vs [K] rows
    np.testing.assert_allclose(gather.history["tx_energy"],
                               dense.history["tx_energy"], rtol=1e-6)


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
def test_streamed_active_gather_matches_the_dense_masked_round(backend):
    """active_gather with k_block streams the m participants in blocks, so
    its K-way sums associate K-block by K-block: STREAM_TOL, as the
    reference holds the same composition (tests/test_streaming.py)."""
    kw = dict(backend=backend, participation=0.5, participation_mode="fixed")
    dense = Experiment(_tiny_spec(**kw), device="cpu")
    dense.run(4, evaluate=False)
    gather = Experiment(_tiny_spec(active_gather=True, k_block=2, **kw),
                        device="cpu")
    gather.run(4, evaluate=False)
    for k in dense.params:
        np.testing.assert_allclose(gather.params[k].numpy(),
                                   dense.params[k].numpy(), **STREAM_TOL)
    assert (gather.history["num_participants"]
            == dense.history["num_participants"])


def test_mask_is_invariant_to_the_blocking():
    """Round t's mask is one [K] draw, sliced per K-block: any k_block sees
    the same participants, and streamed runs of every blocking count and
    charge the same devices."""
    base = runtime.FLConfig(num_devices=12, participation=0.5)
    for t in (1, 2, 7):
        want = runtime._participation_mask(base, t)
        for kb in (1, 2, 3, 4, 6, 12):
            cfg = dataclasses.replace(base, k_block=kb)
            got = runtime._participation_mask(cfg, t)
            assert torch.equal(got, want)
            assert torch.equal(torch.cat([got[i:i + kb]
                                          for i in range(0, 12, kb)]), want)
    hists = []
    for kb in (1, 2, 4, 8):
        e = Experiment(_tiny_spec(participation=0.5, k_block=kb),
                       device="cpu")
        e.run(3, evaluate=False)
        hists.append(e.history)
    for h in hists[1:]:
        assert h["num_participants"] == hists[0]["num_participants"]
        np.testing.assert_allclose(h["tx_energy"], hists[0]["tx_energy"],
                                   rtol=1e-6)


def test_fixed_mode_schedules_the_exact_fraction():
    e = Experiment(_tiny_spec(participation=0.25, participation_mode="fixed"),
                   device="cpu")
    e.run(3, evaluate=False)
    assert e.history["num_participants"] == [2.0] * 3
    full = float(np.sum(np.square(e.state.b)))
    assert all(0 < x < full for x in e.history["tx_energy"])


def test_participation_fold_holds_the_effective_gain():
    h = torch.tensor([0.5, 1.0, 2.0, 4.0])
    b = torch.tensor([1.0, 2.0, 1.0, 0.5])
    b_eff, a_eff = ota.participation_fold(h, b, 3.0,
                                          torch.tensor([1.0, 0.0, 1.0, 0.0]))
    assert torch.equal(b_eff, torch.tensor([1.0, 0.0, 1.0, 0.0]))
    assert float(a_eff * torch.sum(h * b_eff)) == pytest.approx(
        3.0 * float(torch.sum(h * b)), rel=1e-6)
    _, a_none = ota.participation_fold(h, b, 3.0, torch.zeros(4))
    assert float(a_none) == 0.0


def test_spec_passes_the_axes_through():
    with pytest.raises(ValueError, match="fixed"):
        ExperimentSpec(participation=0.5, active_gather=True)
    with pytest.raises(ValueError, match="participation"):
        ExperimentSpec(active_gather=True, participation_mode="fixed")
    spec = _tiny_spec(participation=0.5, participation_mode="fixed",
                      active_gather=True, k_block=2)
    cfg = spec.fl_config()
    assert (cfg.participation, cfg.participation_mode, cfg.active_gather,
            cfg.k_block) == (0.5, "fixed", True, 2)
    over = dataclasses.replace(_tiny_spec(), participation=0.5,
                               participation_mode="fixed", k_block=4,
                               active_gather=True).fl_config()
    assert (over.k_block, over.active_gather) == (4, True)
    e = Experiment(spec, device="cpu")
    e.run(2)
    assert e.history["num_participants"] == [4.0, 4.0]
    with pytest.raises(ValueError, match="mask_provider"):
        runtime.run(_tiny_spec().fl, None, None, None, 1,
                    mask_provider=lambda t: torch.ones(8))
