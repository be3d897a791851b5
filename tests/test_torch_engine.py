"""The compiled driver on the CPU (port of the reference's
``tests/test_engine.py`` contracts): ``driver="scan"`` runs the same round
body as ``driver="python"``, chunk by chunk, so the two give the same bits on
params and on every ``DIAG_KEYS`` history; ``run(5); run(5)`` continues
``run(10)``; chunks end where the reference's ``_plan_chunks`` ends them; a
second identical run builds nothing new.  On the CPU the scan driver runs
the body eagerly; the card's CUDA graph is held to the same contracts in
``tests/test_torch_on_card.py``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro.fed import runtime as jruntime
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.datasets import (device_batches, device_batches_many,
                                       split_dirichlet, split_iid)
from repro_torch.fed import runtime
from repro_torch.fl import DataSpec, EvalSpec, Experiment, ExperimentSpec, \
    ModelSpec, tasks
from repro_torch.kernels import ops
from repro_torch.optim import optimizers as optim

K = 8
ROUNDS = 6

# (FLConfig overrides, run keywords) of each scan == python case
CASES = {
    "adamw": dict(server_opt="adamw", server_weight_decay=0.1),
    "sgd_momentum": dict(server_momentum=0.9),
    "bernoulli": dict(participation=0.5),
    "fixed": dict(participation=0.5, participation_mode="fixed"),
    "fixed_gather": dict(participation=0.5, participation_mode="fixed",
                         active_gather=True),
    "k_block": dict(k_block=2),
    "k_block_lazy": dict(k_block=4),
    "benchmark1": dict(scheme="benchmark1", grad_bound=5.0),
    "onebit": dict(scheme="onebit"),
    "mean": dict(scheme="mean"),
    "mean_masked": dict(scheme="mean", participation=0.5),
    "chunk_1": dict(),
    "chunk_3": dict(),
    "chunk_16": dict(),
}
CHUNKS = {"chunk_1": 1, "chunk_3": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(backend="kernels", **fl):
    return ExperimentSpec(
        fl=runtime.FLConfig(num_devices=K, backend=backend,
                            channel=ChannelConfig(num_devices=K,
                                                  channel_mean=1e-3),
                            smoothness_L=5.0, expected_loss_drop=2.0, **fl),
        data=DataSpec(num_train=200, num_test=50, batch_size=10),
        model=ModelSpec(hidden=8), eval=EvalSpec(every=4))


def _run(cfg, task, driver, rounds=ROUNDS, state=None, lazy=False, **kw):
    """``rounds`` rounds from ``state`` (or a fresh setup) on ``driver``,
    eval every 4; ``lazy`` makes each K-block's batch from the round and
    the device indices (``block_batch_provider``) out of a table of the
    task's batches."""
    if state is None:
        state = runtime.setup(cfg, task.params0, task.model_dim)
    if lazy:
        table = torch.stack([task.batch_provider(t)[0]
                             for t in range(rounds + 1)])
        kw.update(block_batch_provider=lambda t, dev: (table[t][dev],))
    return runtime.run(cfg, state, task.grad_fn,
                       None if lazy else task.batch_provider, rounds,
                       eval_fn=task.eval_fn, eval_every=4, driver=driver,
                       **kw)


def _same(a, b):
    (sa, ha), (sb, hb) = a, b
    assert ha == hb
    for k in sb.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
    assert int(sa.opt_state.step) == int(sb.opt_state.step)
    for field in ("mu", "nu"):
        va, vb = getattr(sa.opt_state, field), getattr(sb.opt_state, field)
        if isinstance(vb, dict):
            for k in vb:
                assert torch.equal(va[k], vb[k]), (field, k)
        else:
            assert torch.equal(va, vb), field


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
@pytest.mark.parametrize("name", list(CASES))
def test_scan_is_bitwise_python(name, backend):
    spec = _spec(backend, **CASES[name])
    cfg = spec.fl_config()
    task = tasks.build_task(spec.data, spec.model, K, "cpu")
    lazy = name == "k_block_lazy"
    scan = _run(cfg, task, "scan", lazy=lazy,
                chunk_size=CHUNKS.get(name, 16),
                chunk_batch_provider=None if lazy
                else task.chunk_batch_provider)
    python = _run(cfg, task, "python", lazy=lazy)
    _same(scan, python)
    assert scan[1]["eval_round"] == [1, 4]


@pytest.mark.parametrize("driver", ["scan", "python"])
@pytest.mark.parametrize("k_block", [None, 4])
def test_empty_round_under_both_drivers(driver, k_block):
    """A round in which nobody transmits is a true no-op on both drivers
    (the device-side gate selects the old params and optimizer state), and
    the rounds around it are the python driver's."""
    spec = _spec(participation=0.5, server_opt="adamw", k_block=k_block)
    cfg = spec.fl_config()
    task = tasks.build_task(spec.data, spec.model, K, "cpu")
    draw = lambda t: (torch.zeros(K) if t == 2
                      else runtime._participation_mask(cfg, t))
    ref_state, _ = _run(cfg, task, "python", rounds=1, mask_provider=draw)
    before = {k: v.clone() for k, v in ref_state.params.items()}
    state, hist = _run(cfg, task, driver, rounds=1, state=ref_state,
                       mask_provider=draw)
    for k in before:
        assert torch.equal(state.params[k], before[k]), k
    assert int(state.opt_state.step) == 1
    assert hist["num_participants"] == [0.0]
    assert hist["update_norm"] == [0.0]
    assert hist["tx_energy"] == [0.0]
    want = _run(cfg, task, "python", rounds=4, mask_provider=draw)
    cont = _run(cfg, task, driver, rounds=2, state=state, mask_provider=draw)
    for k in want[0].params:
        assert torch.equal(cont[0].params[k], want[0].params[k]), k


@pytest.mark.parametrize("backend", ["vmap", "kernels"])
def test_run_5_5_is_run_10_under_scan(backend):
    spec = _spec(backend, participation=0.5, server_opt="adamw")
    a = Experiment(spec, device="cpu")
    a.run(5)
    a.run(5)
    b = Experiment(spec, device="cpu")
    b.run(10)
    assert a.history == b.history
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert a.history["eval_round"] == [1, 4, 8]


@pytest.mark.parametrize("t0,num_rounds,eval_every,chunk_size", [
    (0, 20, 10, 16), (0, 20, None, 16), (0, 1, 10, 16), (5, 5, 4, 3),
    (3, 17, 4, 1), (0, 37, 7, 5), (12, 9, 3, 16), (0, 33, None, 16),
    (99, 3, 100, 2), (0, 10, 1, 4)])
def test_chunks_match_the_reference_plan(t0, num_rounds, eval_every,
                                         chunk_size):
    assert (runtime._plan_chunks(t0, num_rounds, eval_every, chunk_size)
            == jruntime._plan_chunks(t0, num_rounds, eval_every, chunk_size))


@pytest.mark.parametrize("split", ["iid", "dirichlet"])
def test_device_batches_many_stacks_device_batches(split):
    gen = torch.Generator().manual_seed(5)
    if split == "iid":
        sp = split_iid(gen, 300, 7)
    else:
        labels = torch.randint(0, 10, (300,), generator=gen).numpy()
        sp = split_dirichlet(gen, labels, 7, 0.5)
    ts = [3, 1, 4, 1, 5, 9, 26]
    many = device_batches_many(11, sp, 13, ts)
    want = np.stack([device_batches(11, sp, 13, t) for t in ts])
    assert many.shape == (len(ts), 7, 13)
    assert np.array_equal(many, want)


def test_chunk_batch_provider_is_the_stacked_round_batches():
    spec = _spec()
    task = tasks.build_task(spec.data, spec.model, K, "cpu")
    ts = [2, 3, 4, 7]
    (got,) = task.chunk_batch_provider(ts)
    want = torch.stack([task.batch_provider(t)[0] for t in ts])
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(runtime._stack_batches(task.batch_provider, ts)[0],
                       want)


def test_second_identical_run_builds_nothing():
    """cache_info(): the first run builds (on the card: captures) the
    scan engine once; a second identical run reuses it, traces_delta all
    0, as the reference's engine cache does."""
    runtime.clear_compile_caches()
    spec = _spec()
    task = tasks.build_task(spec.data, spec.model, K, "cpu")
    cfg = spec.fl_config()
    runtime.cache_info()
    _run(cfg, task, "scan", chunk_batch_provider=task.chunk_batch_provider)
    first = runtime.cache_info()
    assert first["traces_delta"] == {"round_step": 0, "run_chunk": 1,
                                     "run_chunk_batched": 0,
                                     "fading_refresh": 0}
    _run(cfg, task, "scan", chunk_batch_provider=task.chunk_batch_provider)
    second = runtime.cache_info()
    assert set(second["traces_delta"].values()) == {0}
    assert second["builders"]["run_chunk"]["hits"] >= 1
    _run(cfg, task, "python")
    _run(cfg, task, "python")
    assert runtime.cache_info()["traces_delta"]["round_step"] == 1
    runtime.clear_compile_caches()
    assert runtime.cache_info()["traces"] == {}


def test_unknown_driver_and_bad_chunk_size_raise():
    spec = _spec()
    task = tasks.build_task(spec.data, spec.model, K, "cpu")
    cfg = spec.fl_config()
    with pytest.raises(ValueError, match="driver"):
        _run(cfg, task, "jit")
    with pytest.raises(ValueError, match="chunk_size"):
        _run(cfg, task, "scan", chunk_size=0)


@pytest.mark.parametrize("opt", ["sgd", "sgd_momentum", "adamw"])
def test_optimizer_takes_a_tensor_rate(opt):
    """update(lr=) takes a 0-d fp32 tensor as well as a float, with the
    same bits (the round body passes eta_t so)."""
    make = {"sgd": lambda: optim.sgd(0.0),
            "sgd_momentum": lambda: optim.sgd(0.0, momentum=0.9),
            "adamw": lambda: optim.adamw(0.0, weight_decay=0.1)}[opt]
    gen = torch.Generator().manual_seed(2)
    params = {"w": torch.randn((5, 3), generator=gen),
              "b": torch.randn((3,), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    o = make()
    eta = float(np.float32(0.0123))
    a = o.update(grads, o.init(params), params, lr=eta)
    b = o.update(grads, o.init(params), params,
                 lr=torch.tensor(eta, dtype=torch.float32))
    for k in params:
        assert torch.equal(a[0][k], b[0][k]), k


def test_superpose_takes_a_tensor_gain():
    """ops.ota_superpose's gain is a float or a 0-d fp32 tensor, with the
    same bits (here on the plain versions)."""
    gen = torch.Generator().manual_seed(4)
    g = torch.randn((6, 33), generator=gen)
    scale = torch.rand((6,), generator=gen)
    noise = torch.randn((33,), generator=gen)
    a = float(np.float32(0.37))
    for kb in (None, 2):
        y = ops.ota_superpose(g, scale, noise, a, k_block=kb)
        yt = ops.ota_superpose(g, scale, noise,
                               torch.tensor(a, dtype=torch.float32),
                               k_block=kb)
        assert torch.equal(y, yt)


def test_capture_counts_take_back_and_replay_add():
    """Launch counts under a CUDA graph: what the wrappers count while a
    graph is captured comes back out (the capture runs nothing) and is
    added once per replay."""
    saved = dict(ops.LAUNCH_COUNTS)
    try:
        ops.reset_launch_counts()
        ops.LAUNCH_COUNTS["sumsq"] = 3
        with ops.capture_counts() as per_replay:
            ops.LAUNCH_COUNTS["sumsq"] += 1
            ops.LAUNCH_COUNTS["ota_superpose"] += 100
        assert per_replay["sumsq"] == 1 and per_replay["ota_superpose"] == 100
        assert ops.LAUNCH_COUNTS["sumsq"] == 3
        assert ops.LAUNCH_COUNTS["ota_superpose"] == 0
        ops.replay_counts(per_replay, 4)
        assert ops.LAUNCH_COUNTS["sumsq"] == 7
        assert ops.LAUNCH_COUNTS["ota_superpose"] == 400
    finally:
        ops.LAUNCH_COUNTS.update(saved)


def test_graph_engine_stages_loads_and_resumes(monkeypatch):
    """The card's engine (``_GraphChunks``) without a card: its capture is
    replaced by a graph whose replay runs the captured step eagerly, so
    what surrounds the capture -- the staged buffers, the warm-up on
    scratch copies, the loading of each run's state, the cursor, the
    history rows -- gives the python driver's run bitwise, across runs and
    chunk lengths."""

    class Stream:
        def wait_stream(self, other):
            pass

    class EagerGraphChunks(runtime._GraphChunks):
        def _capture(self):
            self._warm_up()
            self.graph = type("Graph", (), {"replay": staticmethod(
                self._step)})()

    monkeypatch.setattr(runtime, "_capture_stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(
        runtime, "_make_run_chunk",
        lambda cfg, grad_fn, bbf, device, chunk_size, spec: EagerGraphChunks(
            runtime.RoundBody(cfg, grad_fn, bbf), device, chunk_size))
    for over in (dict(participation=0.5, server_opt="adamw"),
                 dict(participation=0.5, participation_mode="fixed",
                      active_gather=True),
                 dict(k_block=2, participation=0.5)):
        a = Experiment(dataclasses.replace(_spec(**over), chunk_size=3),
                       device="cpu")
        a.run(5)
        a.run(6)
        b = Experiment(dataclasses.replace(_spec(**over), driver="python"),
                       device="cpu")
        b.run(11)
        assert a.history == b.history
        for k in b.params:
            assert torch.equal(a.params[k], b.params[k]), (over, k)


# Case I's six leaves (784-64-64-10 MLP, N = 55,050) and the ridge model's
# one leaf
STAGE_SHAPES = {
    "case_i": {"w1": (784, 64), "b1": (64,), "w2": (64, 64), "b2": (64,),
               "w3": (64, 10), "b3": (10,)},
    "ridge": {"w": (30,)},
}


def _lane(seed, noise_var, backend="kernels", k_block=None):
    cfg = runtime.FLConfig(num_devices=4, seed=seed, backend=backend,
                           k_block=k_block,
                           channel=ChannelConfig(num_devices=4,
                                                 noise_var=noise_var))
    return runtime._LaneHost(cfg, torch.ones(4), torch.ones(4), 1.0, 1.0)


@pytest.mark.parametrize("rounds", [1, 16])
@pytest.mark.parametrize("model", list(STAGE_SHAPES))
def test_staged_noise_is_resolve_noise(model, rounds):
    """The staging draws each round's noise straight into its slice of one
    [T, E, N] buffer, leaf by leaf, and scales it in place: the bits of
    ``ota.resolve_noise`` on the same generator, round by round."""
    from repro_torch import rng
    from repro_torch.core import ota
    shapes = {k: torch.Size(v) for k, v in STAGE_SHAPES[model].items()}
    lane = _lane(seed=5, noise_var=3e-7)
    ts = list(range(7, 7 + rounds))
    got = runtime._stage_noise([lane], shapes, ts)
    ocfg = ota.OTAConfig(noise_var=lane.cfg.channel.noise_var)
    want = torch.stack([ota.resolve_noise(ocfg, shapes, "cpu",
                                          rng.generator(lane.cfg.seed + 1, t))
                        for t in ts])
    assert got.shape == (rounds, 1, want.shape[1])
    assert torch.equal(got[:, 0], want)


def test_staged_lanes_are_their_own_runs():
    """A batched chunk stages each lane as its own run stages it; a lane
    without noise in a noisy group stages the zeros its own round adds
    (+0.0 where the dense kernels round hands K2 zeros, -0.0 where the
    round would add nothing)."""
    shapes = {k: torch.Size(v) for k, v in STAGE_SHAPES["case_i"].items()}
    sch = runtime.schemes.get("normalized")
    lanes = [_lane(0, 1e-7), _lane(3, 0.0), _lane(3, 2e-7)]
    ts = [1, 2, 3]
    got = runtime._stage(lanes, sch, shapes, ts,
                         noisy=runtime._noisy([l.cfg for l in lanes]))
    for e, lane in enumerate(lanes):
        alone = runtime._stage([lane], sch, shapes, ts,
                               noisy=runtime._noisy([lane.cfg]))
        for name, v in zip(runtime.RoundInputs._fields, alone):
            if v is not None:
                assert torch.equal(runtime._lane(got, e)._asdict()[name],
                                   v[:, 0]), (e, name)
            elif name != "noise":
                assert getattr(got, name) is None, name
    zero = runtime._lane(got, 1).noise
    assert torch.equal(zero, torch.zeros_like(zero))
    assert not torch.signbit(zero).any()
    for kw in (dict(backend="vmap"), dict(k_block=2)):
        z = runtime._stage([_lane(0, 1e-7, **kw), _lane(1, 0.0, **kw)], sch,
                           shapes, ts, noisy=True).noise[:, 1]
        assert torch.equal(z, torch.zeros_like(z)) and torch.signbit(z).all()
