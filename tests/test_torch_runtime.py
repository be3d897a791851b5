"""The slice as a whole: the port's FL rounds (``repro_torch.fed.runtime``)
against the JAX package's python-driver rounds, round by round.

The JAX package builds the task (data, split, params0), the per-round index
batches, the setup state (h, b, a, eta0 from Algorithm 1) and the per-round
channel noise; ``repro_torch.interop`` carries them across, so both packages
run the same rounds.  Params and every ``DIAG_KEYS`` entry are compared
after each round.

``onebit`` is held only at the aggregate level (tests/test_torch_ota.py):
the sign of an aggregate coordinate near 0 can flip between implementations,
and one flip is enough for two trajectories to part.
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

K = 5
ROUNDS = 5

CASES = {
    # MLP Case I at hidden width 16 (N = 13,002), the paper's schedule
    "mlp_normalized": dict(dataset="synthetic_mnist", scheme="normalized"),
    "mlp_benchmark2": dict(dataset="synthetic_mnist", scheme="benchmark2"),
    # ridge Case II (N = 30)
    "ridge_normalized": dict(dataset="ridge", scheme="normalized"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fl_kwargs(case, constants):
    kw = dict(num_devices=K, scheme=case["scheme"], seed=3)
    if case["dataset"] == "ridge":
        kw.update(case="II", eta=0.01, grad_bound=25.0, s_target=0.995,
                  smoothness_L=constants["smoothness_L"],
                  strong_convexity_M=constants["strong_convexity_M"])
    else:
        kw.update(case="I", p=0.75, smoothness_L=5.0, expected_loss_drop=2.0)
    return kw


def _data_kwargs(case):
    if case["dataset"] == "ridge":
        return dict(dataset="ridge", split="iid", batch_size=20,
                    num_train=200, dim=30, seed=10)
    return dict(dataset="synthetic_mnist", split="dirichlet", alpha=1.0,
                batch_size=20, num_train=300, num_test=100, seed=0)


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The JAX package's rounds on its kernels backend (the main path; the
    reference holds its vmap and kernels backends equal under one noise
    key), one python-driver round per run() call.  Returns what the port
    needs plus the per-round params and history; cached per case, since
    both of the port's backends are held to it."""
    case = CASES[name]
    data = JDataSpec(**_data_kwargs(case))
    model = JModelSpec(hidden=16)
    task = jbuild_task(data, model, K)
    cfg = jruntime.FLConfig(
        backend="kernels", channel=JChannelConfig(num_devices=K,
                                                channel_mean=1e-3),
        **_fl_kwargs(case, task.constants))
    state = jruntime.setup(cfg, task.params0, task.model_dim)
    setup = dict(params=jax.tree_util.tree_map(np.asarray, state.params),
                 h=state.h, h_hat=state.h_hat, b=state.b, a=state.a,
                 eta0=state.eta0, model_dim=state.model_dim)
    key = jax.random.PRNGKey(cfg.seed + 1)
    zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                                   task.params0)
    noise, batches, params, hist = {}, {}, [], []
    for t in range(1, ROUNDS + 1):
        z, _ = ravel_pytree(jschemes.add_channel_noise(
            zeros, jax.random.fold_in(key, t), cfg.channel.noise_var))
        noise[t] = np.array(z)
        batches[t] = np.array(task.batch_provider(t)[0])
        state, h = jruntime.run(cfg, state, task.grad_fn, task.batch_provider,
                                1, driver="python")
        params.append(jax.tree_util.tree_map(np.array, state.params))
        hist.append({k: h[k][0] for k in jruntime.DIAG_KEYS})
    return task, cfg, setup, noise, batches, params, hist


def _port_task(case, jtask):
    """The port's task on the JAX package's data."""
    d = _data_kwargs(case)
    split = FederatedSplit(tuple(jtask.constants["split"].indices))
    params0 = interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtask.params0), device="cpu")
    if case["dataset"] == "ridge":
        return tasks.ridge_task(jtask.constants["x"], jtask.constants["y"],
                                split, params0, lam=0.1,
                                batch_size=d["batch_size"], provider_seed=0,
                                device="cpu")
    n = d["num_train"]
    x, y = jsynthetic_mnist(jax.random.PRNGKey(d["seed"]),
                            n + d["num_test"])
    x, y = np.asarray(x), np.asarray(y)
    return tasks.mlp_task(x[:n], y[:n], x[n:], y[n:], split, params0,
                          batch_size=d["batch_size"], provider_seed=0,
                          device="cpu")


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("name", list(CASES))
def test_rounds_match_reference(name, backend):
    case = CASES[name]
    jtask, jcfg, setup, noise, batches, want_params, want_hist = \
        _reference_run(name)
    task = _port_task(case, jtask)
    assert task.model_dim == jtask.model_dim
    cfg = runtime.FLConfig(
        backend=backend, channel=ChannelConfig(num_devices=K,
                                               channel_mean=1e-3),
        **_fl_kwargs(case, jtask.constants))
    state = interop.state_from_jax(
        setup["params"], setup["h"], setup["h_hat"], setup["b"], setup["a"],
        setup["eta0"], 0, model_dim=setup["model_dim"], device="cpu")
    provider = lambda t: (torch.from_numpy(batches[t]),)
    noise_provider = lambda t: torch.from_numpy(noise[t])
    for t in range(1, ROUNDS + 1):
        state, hist = runtime.run(cfg, state, task.grad_fn, provider, 1,
                                  noise_provider=noise_provider)
        for k, want in want_params[t - 1].items():
            # fp32 gradients and K-way sums associated differently by XLA
            # and PyTorch, compounded over t rounds of eq. 11
            np.testing.assert_allclose(state.params[k].numpy(), want,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} round {t} {k}")
        for k in runtime.DIAG_KEYS:
            # per-round scalars from the same fp32 sums; eta and
            # num_participants are exact, csi_gain_err a hard 0
            assert hist[k][0] == pytest.approx(want_hist[t - 1][k],
                                               rel=1e-4, abs=1e-9), (name, t, k)


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("name", list(CASES))
def test_scan_rounds_match_reference(name, backend):
    """All rounds in one scan run (chunks of 2 rounds) against the JAX
    package's rounds: the final params and every round's diagnostics, at
    the tolerance of ``test_rounds_match_reference``."""
    case = CASES[name]
    jtask, jcfg, setup, noise, batches, want_params, want_hist = \
        _reference_run(name)
    task = _port_task(case, jtask)
    cfg = runtime.FLConfig(
        backend=backend, channel=ChannelConfig(num_devices=K,
                                               channel_mean=1e-3),
        **_fl_kwargs(case, jtask.constants))
    state = interop.state_from_jax(
        setup["params"], setup["h"], setup["h_hat"], setup["b"], setup["a"],
        setup["eta0"], 0, model_dim=setup["model_dim"], device="cpu")
    state, hist = runtime.run(
        cfg, state, task.grad_fn, lambda t: (torch.from_numpy(batches[t]),),
        ROUNDS, driver="scan", chunk_size=2,
        noise_provider=lambda t: torch.from_numpy(noise[t]))
    for k, want in want_params[-1].items():
        np.testing.assert_allclose(state.params[k].numpy(), want,
                                   rtol=1e-4, atol=1e-6, err_msg=f"{name} {k}")
    for t in range(ROUNDS):
        for k in runtime.DIAG_KEYS:
            assert hist[k][t] == pytest.approx(want_hist[t][k], rel=1e-4,
                                               abs=1e-9), (name, t + 1, k)


def _tiny_spec(**fl):
    return ExperimentSpec(
        fl=runtime.FLConfig(num_devices=4, backend="kernels",
                            channel=ChannelConfig(num_devices=4,
                                                  channel_mean=1e-3),
                            smoothness_L=5.0, expected_loss_drop=2.0, **fl),
        data=DataSpec(num_train=200, num_test=50, batch_size=10),
        model=ModelSpec(hidden=8), eval=EvalSpec(every=3))


def test_experiment_on_cpu_runs_and_resumes():
    """The facade end to end on the CPU; run(3); run(3) continues run(6)
    exactly (round-seeded channel noise, persisted optimizer state)."""
    a = Experiment(_tiny_spec(), device="cpu")
    a.run(3)
    a.run(3)
    b = Experiment(_tiny_spec(), device="cpu")
    b.run(6)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert a.history == b.history
    assert a.history["eval_round"] == [1, 3, 6]
    assert np.all(np.isfinite(a.history["train_loss"]))
    assert a.round == 6


def test_vmap_and_kernels_backends_agree_on_cpu():
    runs = []
    for backend in ("vmap", "kernels"):
        spec = _tiny_spec()
        spec = dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, backend=backend))
        e = Experiment(spec, device="cpu")
        e.run(4)
        runs.append(e)
    for k in runs[0].params:
        torch.testing.assert_close(runs[1].params[k], runs[0].params[k],
                                   rtol=1e-5, atol=1e-7)


def test_task_is_deterministic_across_builds():
    spec = _tiny_spec()
    t1 = tasks.build_task(spec.data, spec.model, 4, "cpu")
    t2 = tasks.build_task(spec.data, spec.model, 4, "cpu")
    for k in t1.params0:
        assert torch.equal(t1.params0[k], t2.params0[k])
    assert torch.equal(t1.batch_provider(7)[0], t2.batch_provider(7)[0])
    assert not torch.equal(t1.batch_provider(7)[0], t1.batch_provider(8)[0])


# these two fields raised NotImplementedError until the FL-device mesh was
# ported; each case now holds the port's FLConfig to the reference's on a
# valid and an invalid value (the ids are the ones the cases had)
@pytest.mark.parametrize("field,valid,invalid,error", [
    ("backend", dict(backend="mesh"), dict(backend="mesh", k_block=2),
     "mesh backend"),
    ("device_mesh", dict(device_mesh=2, k_block=1),
     dict(device_mesh=2), "k_block"),
], ids=["backend-mesh-item 15", "device_mesh-2-item 15"])
def test_unported_fl_fields_raise(field, valid, invalid, error):
    """The same values build on both packages, and an invalid one raises
    the same ValueError on both."""
    for cls in (runtime.FLConfig, jruntime.FLConfig):
        cfg = cls(num_devices=4, **valid)
        assert getattr(cfg, field) == valid[field]
        with pytest.raises(ValueError, match=error):
            cls(num_devices=4, **invalid)


@pytest.mark.parametrize("fields,error", [
    (dict(participation=0.5), None),
    (dict(k_block=2), None),
    (dict(k_block=3), "divide"),
    (dict(participation=0.5, participation_mode="fixed", active_gather=True,
          k_block=2), None),
    (dict(participation=0.75, participation_mode="fixed", active_gather=True,
          k_block=2), "active set"),
    (dict(backend="mesh", k_block=2), "mesh"),
])
def test_streaming_and_participation_fields_build(fields, error):
    """participation < 1 and k_block are ported: the configs build, and a
    k_block that does not divide the streamed axis raises ValueError, as
    the reference's FLConfig does (checked on both)."""
    for cls in (runtime.FLConfig, jruntime.FLConfig):
        if error is None:
            cls(num_devices=4, **fields)
        else:
            with pytest.raises(ValueError, match=error):
                cls(num_devices=4, **fields)


def _geometry(pkg, **kw):
    if pkg == "port":
        from repro_torch.channels import GeometryConfig
    else:
        from repro.channels import GeometryConfig
    return GeometryConfig(**kw)


# these four fields raised NotImplementedError until the channel slice was
# ported; each case now holds the port's ChannelConfig to the reference's on
# a valid and an invalid value (the ids are the ones the cases had)
@pytest.mark.parametrize("field,valid,invalid", [
    ("model", dict(model="rician", rician_k=2.0), dict(model="nope")),
    ("csi_error", dict(csi_error=0.1, csi_error_model="multiplicative"),
     dict(csi_error=0.1, csi_error_model="nope")),
    ("geometry", dict(shadowing_std_db=4.0), dict(min_distance=0.0)),
    ("block_fading", dict(block_fading=True, model="ar1", rho=0.9),
     dict(block_fading=True, rho=1.0)),
], ids=["model-rician-item 11", "csi_error-0.1-item 11",
        "geometry-value2-item 11", "block_fading-True-item 5"])
def test_unported_channel_fields_raise(field, valid, invalid):
    """The same values build on both packages, and an invalid value raises
    ValueError on both."""
    for pkg, cls in (("port", ChannelConfig), ("ref", JChannelConfig)):
        if field == "geometry":
            cfg = cls(num_devices=4, geometry=_geometry(pkg, **valid))
            assert cfg.geometry.shadowing_std_db == 4.0
            with pytest.raises(ValueError, match="min_distance"):
                _geometry(pkg, **invalid)
            continue
        cfg = cls(num_devices=4, **valid)
        for k, v in valid.items():
            assert getattr(cfg, k) == v
        with pytest.raises(ValueError):
            cls(num_devices=4, **invalid)


def test_unported_driver_and_client_raise():
    """The scan driver is ported (it raised, naming item 8, until it was):
    it is the spec's default and runs the python driver's rounds bitwise.
    The client algorithms are ported too (they raised, naming item 12,
    until they were): every registered one builds, and an unknown name
    raises ValueError naming the registry."""
    from repro_torch.fl.clients import ClientConfig
    assert ExperimentSpec().driver == "scan"
    runs = []
    for driver in ("scan", "python"):
        e = Experiment(dataclasses.replace(_tiny_spec(), driver=driver),
                       device="cpu")
        e.run(4)
        runs.append(e)
    assert runs[0].history == runs[1].history
    for k in runs[1].params:
        assert torch.equal(runs[0].params[k], runs[1].params[k]), k
    for algo in ("sgd", "fedprox", "feddyn", "scaffold"):
        assert ClientConfig(algo=algo).algo == algo
    with pytest.raises(ValueError, match="unknown client algorithm.*scaffold"):
        ClientConfig(algo="fedavgm")
