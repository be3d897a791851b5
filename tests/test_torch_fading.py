"""Time-varying channels and imperfect CSI in the port's FL engine
(``repro_torch.fed.runtime``): the host refresh of every round (model step,
estimate, Problem-3 re-solve, gain) staged beside the round, both drivers,
resumed runs, batched lanes, and the reference's ``runtime.run`` on the same
draws.

The parity cases take the reference's setup state (``interop``), its index
batches, its channel noise and its per-round fading and estimation normals
(``run(noise_provider=, fading_provider=)``), so both packages run the same
rounds; the port's own model step, estimate, solver and gain run.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.channels import GeometryConfig as JGeometryConfig
from repro.core import schemes as jschemes
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.fed import runtime as jruntime
from repro.fl import DataSpec as JDataSpec
from repro.fl import ModelSpec as JModelSpec
from repro.fl.tasks import build_task as jbuild_task
from repro_torch import interop
from repro_torch.channels import GeometryConfig
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.datasets import FederatedSplit
from repro_torch.fed import runtime as rt
from repro_torch.fl import (DataSpec, EvalSpec, Experiment, ExperimentSpec,
                            ModelSpec, tasks)

K = 4
ROUNDS = 5


def ridge_spec(driver="scan", seed=0, scheme="normalized", **chkw):
    """The reference's tests/test_channels.py::ridge_spec on the kernels
    backend."""
    fl = rt.FLConfig(
        num_devices=K, scheme=scheme, case="II", eta=0.01, backend="kernels",
        channel=ChannelConfig(num_devices=K, channel_mean=1e-3,
                              noise_var=1e-7, **chkw),
        grad_bound=25.0, s_target=0.995, smoothness_L=2.0,
        strong_convexity_M=0.5, seed=seed)
    return ExperimentSpec(
        fl=fl, data=DataSpec(dataset="ridge", split="iid", num_train=200,
                             dim=8, batch_size=16, seed=3),
        model=ModelSpec(kind="ridge"), eval=EvalSpec(every=4),
        driver=driver, chunk_size=3)


def _same(a, b):
    assert a.history == b.history
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k]), k


AXES = [
    dict(model="ar1", rho=0.9),
    dict(model="ar1", rho=0.9, csi_error=0.3),
    dict(model="rician", rician_k=3.0, block_fading=True),
    dict(block_fading=True, csi_error=0.2),
    dict(csi_error=0.2),
    dict(geometry=GeometryConfig(shadowing_std_db=4.0)),
    dict(geometry=GeometryConfig(), block_fading=True, csi_error=0.1),
]


@pytest.mark.parametrize("chkw", AXES, ids=lambda a: ",".join(
    f"{k}={getattr(v, 'cell_radius', v)}" for k, v in a.items()))
def test_scan_is_python(chkw):
    """The reference's TestEngineIntegration.AXES: both drivers, 7 rounds
    (chunks of 3, eval every 4), bitwise."""
    runs = [Experiment(ridge_spec(d, **chkw), device="cpu")
            for d in ("scan", "python")]
    for e in runs:
        e.run(7)
    _same(*runs)
    state = runs[0].state
    assert (state.fad_state is not None) == (chkw.get("model") == "ar1")
    assert (state.scale is not None) == ("geometry" in chkw)


def test_streamed_round_takes_the_staged_channel():
    """The k_block round reads the staged h_t and h_hat_t as the dense round
    does: scan == python bitwise, and the dense round's trajectory at the
    reference's streamed-vs-dense tolerance (rtol 3e-4, atol 1e-6: the K-way
    sums associate K-block by K-block)."""
    chkw = dict(model="ar1", rho=0.9, csi_error=0.2)
    runs = []
    for driver in ("scan", "python"):
        spec = ridge_spec(driver, **chkw)
        e = Experiment(dataclasses.replace(spec, k_block=2), device="cpu")
        e.run(6)
        runs.append(e)
    _same(*runs)
    dense = Experiment(ridge_spec(**chkw), device="cpu")
    dense.run(6)
    for k in dense.params:
        np.testing.assert_allclose(runs[0].params[k].numpy(),
                                   dense.params[k].numpy(), rtol=3e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(runs[0].history["csi_gain_err"],
                               dense.history["csi_gain_err"], rtol=3e-4,
                               atol=1e-6)


@pytest.mark.parametrize("over", [
    dict(participation=0.5),
    dict(participation=0.5, participation_mode="fixed", active_gather=True),
], ids=["bernoulli", "fixed_gather"])
def test_masked_rounds_fold_the_refreshed_channel(over):
    """Partial participation under block fading with an estimate: each
    round's mask folds into that round's re-solved ``b_t`` and ``a_t``;
    scan == python bitwise."""
    runs = []
    for driver in ("scan", "python"):
        spec = ridge_spec(driver, block_fading=True, csi_error=0.2)
        e = Experiment(dataclasses.replace(spec, **over), device="cpu")
        e.run(6)
        runs.append(e)
    _same(*runs)
    assert set(runs[0].history["num_participants"]) <= {0.0, 1.0, 2.0, 3.0,
                                                        4.0}


def test_resume_is_one_run():
    """run(3); run(3) == run(6) under AR(1) with imperfect CSI: the channel,
    its fading state, the params and every history, bitwise."""
    spec = ridge_spec(model="ar1", rho=0.8, csi_error=0.1)
    once = Experiment(spec, device="cpu")
    once.run(6)
    twice = Experiment(spec, device="cpu")
    twice.run(3)
    twice.run(3)
    _same(twice, once)
    for name in ("h", "h_hat", "b", "fad_state"):
        assert np.array_equal(getattr(twice.state, name),
                              getattr(once.state, name)), name
    assert twice.state.a == once.state.a
    assert twice.state.eff_gain == once.state.eff_gain


def test_ar1_rho0_is_block_fading():
    ar = Experiment(ridge_spec(model="ar1", rho=0.0), device="cpu")
    bf = Experiment(ridge_spec(block_fading=True), device="cpu")
    ar.run(5)
    bf.run(5)
    _same(ar, bf)


def test_ar1_without_fading_state_raises():
    e = Experiment(ridge_spec(model="ar1", rho=0.5), device="cpu").setup()
    e.state.fad_state = None
    with pytest.raises(ValueError, match="fading state"):
        e.run(1)


def test_csi_gain_err_and_refresh_counts():
    """A hard 0 under perfect CSI (fixed and block fading); one constant
    value on a fixed channel with an estimate; a new value every round
    under block fading.  The refresh is host code: nothing is built or
    captured for it."""
    rt.cache_info()
    for chkw in ({}, dict(block_fading=True)):
        e = Experiment(ridge_spec(**chkw), device="cpu")
        e.run(4)
        assert e.history["csi_gain_err"] == [0.0] * 4
    fixed = Experiment(ridge_spec(csi_error=0.3), device="cpu")
    fixed.run(4)
    assert len(set(fixed.history["csi_gain_err"])) == 1
    assert fixed.history["csi_gain_err"][0] != 0.0
    fading = Experiment(ridge_spec(csi_error=0.3, block_fading=True),
                        device="cpu")
    fading.run(4)
    assert len(set(fading.history["csi_gain_err"])) == 4
    assert rt.cache_info()["traces_delta"]["fading_refresh"] == 0
    with pytest.raises(ValueError, match="fixed"):
        rt.run(fixed.cfg, fixed.state, fixed.task.grad_fn,
               fixed.task.batch_provider, 1,
               fading_provider=lambda t: (torch.zeros(K, 2), None))


@pytest.mark.parametrize("axis,values,chkw", [
    ("csi_error", (0.0, 0.1, 0.3), dict(block_fading=True)),
    ("rho", (0.0, 0.5, 0.9), dict(model="ar1",
                                  geometry=GeometryConfig(
                                      shadowing_std_db=4.0))),
    ("channel_mean", (1e-3, 2e-3, 5e-4), dict(model="ar1", rho=0.7,
                                              csi_error=0.2)),
], ids=["csi_error", "rho_geometry", "channel_mean"])
def test_batched_lanes_are_their_runs(axis, values, chkw):
    """``run_batched`` lanes that differ in a channel field (with seeds
    apart): each lane bitwise its own ``run``, history, params and channel
    state."""
    spec = ridge_spec(**chkw)
    cfgs = [dataclasses.replace(spec.fl, seed=i, channel=dataclasses.replace(
        spec.fl.channel, **{axis: v})) for i, v in enumerate(values)]
    task = tasks.build_task(spec.data, spec.model, K, "cpu")
    states = [rt.setup(c, task.params0, task.model_dim) for c in cfgs]
    states, hist = rt.run_batched(cfgs, states, task.grad_fn,
                                  task.batch_provider, 6, chunk_size=4)
    for e, c in enumerate(cfgs):
        solo = rt.setup(c, task.params0, task.model_dim)
        solo, h = rt.run(c, solo, task.grad_fn, task.batch_provider, 6,
                         chunk_size=4)
        for k in rt.DIAG_KEYS:
            assert np.array_equal(hist[k][e], np.asarray(h[k])), (e, k)
        for k in solo.params:
            assert torch.equal(states[e].params[k], solo.params[k])
        for name in ("h", "h_hat", "b", "fad_state", "scale"):
            a, b = getattr(states[e], name), getattr(solo, name)
            assert (a is None and b is None) or np.array_equal(a, b), name
        assert states[e].a == solo.a


# ---------------------------------------------------------------------------
# the reference's runtime.run on the same draws

PARITY = {
    "fading_normalized": dict(scheme="normalized",
                              channel=dict(block_fading=True)),
    "fading_benchmark1": dict(scheme="benchmark1",
                              channel=dict(block_fading=True)),
    "fixed_csi": dict(scheme="normalized", channel=dict(csi_error=0.2)),
    "fading_csi": dict(scheme="normalized",
                       channel=dict(block_fading=True, csi_error=0.2)),
    "ar1_csi_geometry": dict(scheme="normalized",
                             channel=dict(model="ar1", rho=0.8,
                                          csi_error=0.2, geometry="geo")),
}


def _channel_kwargs(case, pkg):
    kw = dict(PARITY[case]["channel"])
    if kw.get("geometry") == "geo":
        cls = GeometryConfig if pkg == "port" else JGeometryConfig
        kw["geometry"] = cls(shadowing_std_db=3.0)
    return kw


def _fl_kwargs(case, pkg):
    cls = ChannelConfig if pkg == "port" else JChannelConfig
    return dict(num_devices=K, scheme=PARITY[case]["scheme"], case="II",
                eta=0.01, backend="kernels", seed=3,
                channel=cls(num_devices=K, channel_mean=1e-3,
                            noise_var=1e-7, **_channel_kwargs(case, pkg)),
                grad_bound=25.0, s_target=0.995, smoothness_L=2.0,
                strong_convexity_M=0.5)


@functools.lru_cache(maxsize=None)
def _reference_run(case):
    """The reference's setup and ``ROUNDS`` rounds (one scan chunk), with
    the draws the port needs: index batches, flat noise, and per round the
    [K, 2] fading normals and the [K] estimation normals."""
    data = JDataSpec(dataset="ridge", split="iid", num_train=200, dim=8,
                     batch_size=16, seed=3)
    task = jbuild_task(data, JModelSpec(kind="ridge"), K)
    cfg = jruntime.FLConfig(**_fl_kwargs(case, "ref"))
    state = jruntime.setup(cfg, task.params0, task.model_dim)
    setup = dict(params=jax.tree_util.tree_map(np.asarray, state.params),
                 h=state.h, h_hat=state.h_hat, b=state.b, a=state.a,
                 eta0=state.eta0, model_dim=state.model_dim,
                 fad_state=state.fad_state, scale=state.scale)
    key = jax.random.PRNGKey(cfg.seed + 1)
    chan_key = jax.random.PRNGKey(cfg.seed + 2)
    csi_key = jax.random.fold_in(chan_key, jruntime._CSI_SALT)
    zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                                   task.params0)
    draws = {}
    for t in range(1, ROUNDS + 1):
        z, _ = ravel_pytree(jschemes.add_channel_noise(
            zeros, jax.random.fold_in(key, t), cfg.channel.noise_var))
        w = jax.random.normal(jax.random.fold_in(chan_key, t), (K, 2))
        e = jax.random.normal(jax.random.fold_in(csi_key, t), (K,))
        draws[t] = (np.array(task.batch_provider(t)[0]), np.array(z),
                    np.array(w), np.array(e))
    state, hist = jruntime.run(cfg, state, task.grad_fn, task.batch_provider,
                               ROUNDS, chunk_size=ROUNDS)
    params = jax.tree_util.tree_map(np.array, state.params)
    return task, setup, draws, params, hist, np.array(state.h)


@pytest.mark.parametrize("case", list(PARITY))
def test_rounds_match_reference(case):
    """5 rounds against the reference's ``runtime.run``, at
    tests/test_torch_runtime.py::test_rounds_match_reference's tolerance
    (rtol 1e-4, atol 1e-6 on the params; rel 1e-4, abs 1e-9 on every
    ``DIAG_KEYS`` entry, ``csi_gain_err`` included)."""
    jtask, setup, draws, want_params, want_hist, want_h = \
        _reference_run(case)
    split = FederatedSplit(tuple(jtask.constants["split"].indices))
    params0 = interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtask.params0), device="cpu")
    task = tasks.ridge_task(jtask.constants["x"], jtask.constants["y"],
                            split, params0, lam=0.1, batch_size=16,
                            provider_seed=0, device="cpu")
    cfg = rt.FLConfig(**_fl_kwargs(case, "port"))
    state = interop.state_from_jax(
        setup["params"], setup["h"], setup["h_hat"], setup["b"], setup["a"],
        setup["eta0"], 0, model_dim=setup["model_dim"],
        fad_state=setup["fad_state"], scale=setup["scale"], device="cpu")
    csi = cfg.channel.csi_error > 0.0
    state, hist = rt.run(
        cfg, state, task.grad_fn, lambda t: (torch.from_numpy(draws[t][0]),),
        ROUNDS, chunk_size=2,
        noise_provider=lambda t: torch.from_numpy(draws[t][1]),
        fading_provider=(None if not cfg.channel.time_varying() else
                         lambda t: (torch.from_numpy(draws[t][2]),
                                    torch.from_numpy(draws[t][3])
                                    if csi else None)))
    for k, want in want_params.items():
        # fp32 gradients, K-way sums and Problem-3 solves in other orders
        np.testing.assert_allclose(state.params[k].numpy(), want, rtol=1e-4,
                                   atol=1e-6, err_msg=f"{case} {k}")
    for t in range(ROUNDS):
        for k in rt.DIAG_KEYS:
            assert hist[k][t] == pytest.approx(float(want_hist[k][t]),
                                               rel=1e-4, abs=1e-9), \
                (case, t + 1, k)
    np.testing.assert_allclose(state.h, want_h, rtol=1e-6)
    if csi:
        assert all(v != 0.0 for v in hist["csi_gain_err"])
