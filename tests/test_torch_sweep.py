"""The port's sweep engine on the CPU (port of the reference's
``tests/test_sweep.py`` classes the port can run): ``SweepSpec`` geometry,
axis errors and classification; ``structural_config``; ``run_batched``'s
validation; a batched grid against the same grid run point by point,
BITWISE (each lane runs its own config's round body on its own state, so
the port holds its lanes to more than the reference's 1-2 ulp); the port's
batched run against the reference's ``run_batched`` at fp32 tolerance; the
result's ``band``, ``point_index``, ``curves`` and ``dump``; the params
digest against ``repro.obs``; and the engine and task caches.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro.fl.sweep as jsweep
from repro import obs as jobs
from repro.core import schemes as jschemes
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.fed import runtime as jrt
from repro.fl import DataSpec as JDataSpec
from repro.fl import EvalSpec as JEvalSpec
from repro.fl import ExperimentSpec as JExperimentSpec
from repro.fl import ModelSpec as JModelSpec
from repro.fl.tasks import build_task as jbuild_task
from repro_torch import interop, obs
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.datasets import FederatedSplit
from repro_torch.fed import runtime as rt
from repro_torch.fl import (DataSpec, EvalSpec, Experiment, ExperimentSpec,
                            ModelSpec, SweepSpec, apply_axis, resolve_axis,
                            run_sweep, tasks)
from repro_torch.fl.sweep import (BATCHABLE, STRUCTURAL, classify_field,
                                  _structural_signature)

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 4
ROUNDS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ridge_spec(**fl_kw):
    fl = dict(num_devices=K, scheme="normalized", case="II", eta=0.01,
              channel=ChannelConfig(num_devices=K, channel_mean=1e-3),
              grad_bound=25.0, s_target=0.995, smoothness_L=2.0,
              strong_convexity_M=0.5, seed=0, backend="kernels")
    fl.update(fl_kw)
    return ExperimentSpec(
        fl=rt.FLConfig(**fl),
        data=DataSpec(dataset="ridge", split="iid", num_train=200, dim=8,
                      batch_size=16, seed=3),
        model=ModelSpec(kind="ridge"), eval=EvalSpec(every=5), chunk_size=3)


def mnist_spec(**fl_kw):
    fl = dict(num_devices=K, scheme="normalized", case="I", p=0.75,
              channel=ChannelConfig(num_devices=K, channel_mean=1e-3,
                                    noise_var=1e-7),
              grad_bound=10.0, smoothness_L=5.0, expected_loss_drop=2.0,
              seed=0, backend="kernels")
    fl.update(fl_kw)
    return ExperimentSpec(
        fl=rt.FLConfig(**fl),
        data=DataSpec(dataset="synthetic_mnist", split="dirichlet",
                      num_train=300, num_test=60, batch_size=16, seed=0),
        model=ModelSpec(kind="mlp", hidden=8),
        eval=EvalSpec(every=5), chunk_size=3)


def assert_bitwise(sweep, rounds=ROUNDS):
    """The batched grid == the same grid point by point, bitwise: every
    history (DIAG_KEYS and eval metrics) and each point's params digest."""
    res_b = run_sweep(sweep, rounds, device="cpu")
    res_s = run_sweep(sweep, rounds, vectorized=False, device="cpu")
    assert res_b.rounds == res_s.rounds == list(range(1, rounds + 1))
    assert res_b.eval_rounds == res_s.eval_rounds
    assert set(res_b.history) == set(res_s.history)
    for key in res_b.history:
        np.testing.assert_array_equal(res_b.history[key],
                                      res_s.history[key], err_msg=key)
    assert res_b.params_digests == res_s.params_digests
    assert None not in res_b.params_digests
    return res_b


class TestSweepSpecGeometry:
    def test_shape_size_values_and_order(self):
        sweep = SweepSpec(ridge_spec(), {"s_target": (0.98, 0.99),
                                         "seed": (0, 1, 2)})
        assert sweep.names == ("s_target", "seed")
        assert sweep.shape == (2, 3) and sweep.size == 6
        assert sweep.values("seed") == (0, 1, 2)
        pts = sweep.points()
        assert [p.index for p in pts[:4]] == [(0, 0), (0, 1), (0, 2), (1, 0)]
        assert pts[4].coords == (("s_target", 0.99), ("seed", 1))
        assert pts[4].spec.fl.s_target == 0.99 and pts[4].spec.fl.seed == 1

    def test_mapping_and_pair_axes_agree(self):
        a = SweepSpec(ridge_spec(), {"seed": (0, 1)})
        b = SweepSpec(ridge_spec(), (("seed", (0, 1)),))
        assert a.axes == b.axes

    def test_dotted_names_disambiguate(self):
        assert resolve_axis("seed") == ("fl", "seed")
        assert resolve_axis("data.seed") == ("data", "seed")
        assert resolve_axis("noise_var") == ("channel", "noise_var")
        assert resolve_axis("alpha") == ("data", "alpha")
        assert resolve_axis("client.alpha") == ("client", "alpha")
        spec = apply_axis(ridge_spec(), "data.seed", 9)
        assert spec.data.seed == 9 and spec.fl.seed == 0

    def test_axis_errors(self):
        with pytest.raises(ValueError, match="unknown sweep axis"):
            SweepSpec(ridge_spec(), {"not_a_field": (1,)})
        with pytest.raises(ValueError, match="not sweepable"):
            SweepSpec(ridge_spec(), {"driver": ("scan", "python")})
        with pytest.raises(ValueError, match="no values"):
            SweepSpec(ridge_spec(), {"seed": ()})
        with pytest.raises(ValueError, match="mixes composite"):
            SweepSpec(ridge_spec(), {"seed": (("a", {"seed": 1}), 2)})
        with pytest.raises(ValueError, match="unknown sweep scope"):
            resolve_axis("nope.seed")
        with pytest.raises(ValueError, match="duplicate"):
            SweepSpec(ridge_spec(), (("seed", (0,)), ("seed", (1,))))
        with pytest.raises(ValueError):        # invalid value fails eagerly
            SweepSpec(ridge_spec(), {"scheme": ("normalized", "nope")})
        # the channel axes build (they raised NotImplementedError until the
        # channel slice was ported); an unknown model fails eagerly
        SweepSpec(ridge_spec(), {"channel.model": ("rayleigh", "ar1")})
        with pytest.raises(ValueError, match="unknown channel model"):
            SweepSpec(ridge_spec(), {"channel.model": ("rayleigh", "nope")})

    def test_classify_field_matches_the_reference(self):
        """Every field name of every scope, bare and dotted, classifies as
        in the reference."""
        assert classify_field("seed") == BATCHABLE
        assert classify_field("channel.noise_var") == BATCHABLE
        assert classify_field("scheme") == STRUCTURAL
        assert classify_field("data.alpha") == STRUCTURAL
        names = []
        for scope, cls in (("fl", rt.FLConfig), ("channel", ChannelConfig),
                           ("data", DataSpec), ("model", ModelSpec)):
            for f in dataclasses.fields(cls):
                names += [f.name, f"{scope}.{f.name}"]
        names += ["client.mu", "client.alpha", "client.algo"]
        for name in names:
            assert resolve_axis(name) == jsweep.resolve_axis(name), name
            assert classify_field(name) == jsweep.classify_field(name), name

    def test_classification(self):
        sweep = SweepSpec(
            ridge_spec(),
            {"seed": (0, 1), "noise_var": (0.0, 1e-7), "eta": (0.01, 0.02),
             "s_target": (0.98, 0.99), "grad_bound": (10.0, 25.0),
             "b_max": (1.0, 2.0), "channel_mean": (1e-3, 2e-3),
             "rho": (0.0, 0.9), "scheme": ("normalized", "benchmark1"),
             "participation": (0.5, 1.0), "alpha": (0.5, 1.0)})
        cls = sweep.classification()
        for name in ("seed", "noise_var", "eta", "s_target", "grad_bound",
                     "b_max", "channel_mean", "rho"):
            assert cls[name] == BATCHABLE, name
        for name in ("scheme", "participation", "alpha"):
            assert cls[name] == STRUCTURAL, name

    def test_bare_model_axis_is_the_channel_model(self):
        assert resolve_axis("model") == ("channel", "model")
        assert resolve_axis("model.hidden") == ("model", "hidden")
        spec = apply_axis(mnist_spec(), "model.hidden", 4)
        assert spec.model.hidden == 4

    def test_composite_classification(self):
        sweep = SweepSpec(ridge_spec(), {
            "setup": (("caseI", {"case": "I", "p": 0.75, "s_target": None,
                                 "expected_loss_drop": 2.0}),
                      ("caseII", {"case": "II", "s_target": 0.98})),
            "target": (("a", {"s_target": 0.98}), ("b", {"eta": 0.02}))})
        cls = sweep.classification()
        assert cls["target"] == BATCHABLE
        assert cls["setup"] == STRUCTURAL
        assert sweep.values("setup") == ("caseI", "caseII")
        pts = sweep.points()
        assert pts[0].coords == (("setup", "caseI"), ("target", "a"))
        assert pts[0].spec.fl.case == "I"
        assert pts[0].spec.fl.s_target == 0.98

    def test_scenario_override_axis_beats_base_override(self):
        base = dataclasses.replace(ridge_spec(), server_opt="adamw")
        spec = apply_axis(base, "server_opt", "sgd")
        assert spec.fl_config().server_opt == "sgd"

    def test_num_devices_axis_keeps_channel_in_sync(self):
        spec = apply_axis(ridge_spec(), "num_devices", 6)
        assert spec.fl.num_devices == 6
        assert spec.fl.channel.num_devices == 6
        with pytest.raises(ValueError, match="keeps the channel length"):
            apply_axis(ridge_spec(), "channel.num_devices", 6)

    def test_num_devices_axis_runs(self):
        res = assert_bitwise(SweepSpec(ridge_spec(),
                                       {"num_devices": (3, 5)}), rounds=3)
        assert res.history["num_participants"][:, 0].tolist() == [3.0, 5.0]

    def test_structural_signature_collapses_batchables(self):
        a = _structural_signature(SweepSpec(ridge_spec(),
                                            {"seed": (0,)}).points()[0].spec)
        b = _structural_signature(
            SweepSpec(ridge_spec(), {"seed": (7,), "noise_var": (3e-7,),
                                     "s_target": (0.9,)}).points()[0].spec)
        assert a == b
        c = _structural_signature(
            SweepSpec(ridge_spec(),
                      {"scheme": ("benchmark1",)}).points()[0].spec)
        assert a != c


class TestStructuralConfig:
    BATCHED = dict(seed=4, eta=0.02, s_target=0.9, epsilon_target=0.1,
                   grad_bound=3.0, smoothness_L=2.5, strong_convexity_M=0.3,
                   expected_loss_drop=1.5, theta_th=0.5)
    CHANNEL = dict(noise_var=2e-7, channel_mean=2e-3, b_max=1.5, rho=0.5)
    STRUCTURAL = dict(scheme="benchmark1", case="I", p=0.5,
                      amplification="bmax", server_opt="adamw",
                      server_momentum=0.5, local_steps=2, local_lr=0.1,
                      participation=0.5, k_block=2, backend="vmap")

    def test_tables_are_the_reference_tables(self):
        for name in ("BATCHED_FL_FIELDS", "BATCHED_CHANNEL_FIELDS",
                     "STRUCTURAL_FL_FIELDS", "STRUCTURAL_CHANNEL_FIELDS"):
            assert getattr(rt, name) == getattr(jrt, name), name
        assert rt.BatchAxes._fields == jrt.BatchAxes._fields
        fl = {f.name for f in dataclasses.fields(rt.FLConfig)}
        assert fl == set(rt.BATCHED_FL_FIELDS) | set(rt.STRUCTURAL_FL_FIELDS)
        ch = {f.name for f in dataclasses.fields(ChannelConfig)}
        assert ch == (set(rt.BATCHED_CHANNEL_FIELDS)
                      | set(rt.STRUCTURAL_CHANNEL_FIELDS))

    @pytest.mark.parametrize("field", list(BATCHED) + list(CHANNEL))
    def test_batchable_fields_collapse(self, field):
        base = ridge_spec().fl
        if field in self.CHANNEL:
            other = dataclasses.replace(base, channel=dataclasses.replace(
                base.channel, **{field: self.CHANNEL[field]}))
        else:
            other = dataclasses.replace(base, **{field: self.BATCHED[field]})
        assert other != base
        assert rt.structural_config(other) == rt.structural_config(base)

    @pytest.mark.parametrize("field", list(STRUCTURAL))
    def test_structural_fields_stay(self, field):
        base = ridge_spec().fl
        other = dataclasses.replace(base, **{field: self.STRUCTURAL[field]})
        assert rt.structural_config(other) != rt.structural_config(base)

    def test_grad_bound_keeps_its_none_ness(self):
        base = ridge_spec(case="I", s_target=None).fl
        none = dataclasses.replace(base, grad_bound=None)
        assert rt.structural_config(none).grad_bound is None
        assert rt.structural_config(base).grad_bound == 1.0


class TestBatchedSequentialBitwise:
    AXES = [
        {"seed": (0, 1, 2)},
        {"noise_var": (0.0, 1e-7, 1e-6)},
        {"eta": (0.005, 0.01, 0.02)},
        {"s_target": (0.98, 0.99, 0.995)},
        {"b_max": (1.0, math.sqrt(5.0))},
        {"channel_mean": (1e-3, 2e-3)},
        {"seed": (0, 1), "noise_var": (1e-7, 1e-6)},
    ]

    @pytest.mark.parametrize("backend", ["kernels", "vmap"])
    @pytest.mark.parametrize("axes", AXES, ids=lambda a: "+".join(a))
    def test_axis_ridge(self, axes, backend):
        assert_bitwise(SweepSpec(ridge_spec(backend=backend), axes))

    @pytest.mark.parametrize("scheme", ["benchmark1", "clipped"])
    def test_grad_bound_axis(self, scheme):
        # schemes that read G in the round: each lane reads its own
        assert_bitwise(SweepSpec(ridge_spec(scheme=scheme),
                                 {"grad_bound": (0.5, 10.0, 25.0)}))

    def test_seeds_mnist_composed_scenario_axes(self):
        spec = mnist_spec(participation=0.5, server_opt="adamw",
                          local_steps=2, local_lr=0.05)
        assert_bitwise(SweepSpec(spec, {"seed": (0, 1, 2)}))

    @pytest.mark.parametrize("algo,axis", [
        ("fedprox", {"client.mu": (0.0, 0.5)}),
        ("feddyn", {"client.alpha": (0.01, 0.3)}),
    ])
    def test_client_axes(self, algo, axis):
        # mu and alpha are lanes: each reaches its lane's round from device
        # memory, so a value baked into the body (built from the structural
        # config, mu = 0.0, alpha = 0.01) breaks the lane that differs
        from repro_torch.fl.clients import ClientConfig
        spec = mnist_spec(local_steps=2, local_lr=0.05,
                          client=ClientConfig(algo=algo))
        res = assert_bitwise(SweepSpec(spec, axis), rounds=4)
        assert len(set(res.params_digests)) == res.sweep.size

    def test_noise_var_with_zero_on_the_streamed_gather_round(self):
        spec = mnist_spec(participation=0.5, participation_mode="fixed",
                          active_gather=True, k_block=1, backend="vmap")
        assert_bitwise(SweepSpec(spec, {"noise_var": (0.0, 1e-6)}), rounds=4)

    def test_matches_independent_experiment_runs(self):
        """The contract literally: the batched sweep against freshly made
        ``Experiment.run`` trajectories."""
        sweep = SweepSpec(ridge_spec(), {"seed": (0, 1, 2),
                                         "noise_var": (1e-7, 1e-6)})
        res = run_sweep(sweep, ROUNDS, device="cpu")
        for i, pt in enumerate(sweep.points()):
            e = Experiment(pt.spec, device="cpu")
            e.run(ROUNDS)
            assert e.history["round"] == res.rounds
            assert e.history["eval_round"] == res.eval_rounds
            for key in ("gap", "loss", "update_norm", "tx_energy", "eta"):
                assert res.history[key][i].tolist() == e.history[key], key
            assert res.params_digests[i] == obs.params_sha256(e.params)

    def test_structural_axis_grouping(self):
        sweep = SweepSpec(ridge_spec(),
                          {"scheme": ("normalized", "benchmark1"),
                           "seed": (0, 1)})
        res = assert_bitwise(sweep)
        grid = res.grid("gap")
        assert grid.shape[:2] == (2, 2)
        assert not np.allclose(grid[0, 0], grid[1, 0])
        assert not np.allclose(grid[0, 0], grid[0, 1])

    def test_mixed_task_metrics_raise(self):
        base = dataclasses.replace(ridge_spec(), model=ModelSpec(kind="auto"))
        sweep = SweepSpec(base, {"dataset": ("ridge", "synthetic_mnist")})
        with pytest.raises(ValueError, match="history keys"):
            run_sweep(sweep, 2, device="cpu")


class TestResult:
    @pytest.fixture(scope="class")
    def res(self):
        sweep = SweepSpec(ridge_spec(), {"s_target": (0.98, 0.99),
                                         "seed": (0, 1, 2)})
        return run_sweep(sweep, ROUNDS, device="cpu")

    def test_band_reduces_seed_axis(self, res):
        mean, std = res.band("gap", over="seed")
        grid = res.grid("gap")
        np.testing.assert_allclose(mean, grid.mean(axis=1))
        np.testing.assert_allclose(std, grid.std(axis=1))
        assert mean.shape == (2, len(res.eval_rounds))
        with pytest.raises(ValueError, match="no sweep axis"):
            res.band("gap", over="eta")

    def test_point_index(self, res):
        i = res.point_index(s_target=0.99, seed=2)
        assert res.points[i].coords == (("s_target", 0.99), ("seed", 2))
        with pytest.raises(ValueError, match="pin every axis"):
            res.point_index(seed=2)

    def test_curves(self, res):
        curves = res.curves("s_target", "gap")
        mean, std = res.band("gap")
        assert list(curves) == ["0.98", "0.99"]
        assert curves["0.99"]["round"] == res.eval_rounds
        assert curves["0.99"]["gap"] == mean[1].tolist()
        assert curves["0.99"]["gap_std"] == std[1].tolist()
        assert curves["0.98"]["seeds"] == 3

    def test_dump_and_manifest(self, res, tmp_path):
        path = res.dump(str(tmp_path / "sweep.json"))
        payload = json.loads(pathlib.Path(path).read_text())
        assert payload["shape"] == [2, 3]
        assert payload["rounds"] == res.rounds
        assert payload["params_digests"] == res.params_digests
        assert payload["history"]["gap"] == res.history["gap"].tolist()
        assert payload["bands"]["gap"]["mean"] == res.band("gap")[0].tolist()
        man = payload["manifest"]
        assert man["params_sha256"] == res.params_sha256()
        assert man["sweep_shape"] == [2, 3]
        assert man["axis_classification"] == {"s_target": BATCHABLE,
                                              "seed": BATCHABLE}
        assert man["structural_signature"] == obs.structural_signature(
            res.sweep.base.fl_config())
        assert man["torch_version"] == torch.__version__


class TestManifest:
    def test_params_digest_is_the_reference_digest(self):
        """Bitwise-equal params give the same digest in both packages."""
        rng = np.random.default_rng(0)
        params = {"w1": rng.standard_normal((5, 3)).astype(np.float32),
                  "b1": np.zeros(3, np.float32),
                  "a": rng.standard_normal(()).astype(np.float32)}
        want = jobs.params_sha256(
            jax.tree_util.tree_map(jnp.asarray, params))
        assert obs.params_sha256(params) == want
        assert obs.params_sha256(
            interop.params_from_jax(params, device="cpu")) == want
        params["b1"][0] = 1.0
        assert obs.params_sha256(params) != want

    def test_config_hash_and_signature(self):
        a, b = ridge_spec(), ridge_spec(seed=5)
        assert obs.config_sha256(a) == obs.config_sha256(ridge_spec())
        assert obs.config_sha256(a) != obs.config_sha256(b)
        assert (obs.structural_signature(a.fl_config())
                == obs.structural_signature(b.fl_config()))
        man = obs.run_manifest(spec=a, params={"w": np.zeros(2, np.float32)})
        assert man["spec"]["fl"]["seed"] == 0
        assert {"torch_version", "cuda_version", "backend",
                "local_devices"} <= set(man)


def _cfg_state(**kw):
    spec = ridge_spec(**kw)
    task = tasks.build_task(spec.data, spec.model, K, "cpu")
    cfg = spec.fl_config()
    return cfg, rt.setup(cfg, task.params0, task.model_dim), task


class TestRunBatchedValidation:
    def test_structural_mismatch_raises(self):
        c1, s1, task = _cfg_state()
        c2, s2, _ = _cfg_state(scheme="benchmark1")
        with pytest.raises(ValueError, match="structurally identical"):
            rt.run_batched([c1, c2], [s1, s2], task.grad_fn,
                           task.batch_provider, 2)

    @pytest.mark.parametrize("over", [dict(backend="mesh"),
                                      dict(device_mesh=2, k_block=1)],
                             ids=["mesh_backend", "device_mesh"])
    def test_run_batched_rejects_mesh_and_device_mesh(self, over):
        """The mesh backend and device_mesh build, and a batched run
        rejects both with the reference's ValueError: their rounds own the
        ranks of the FL-device axis (the sweep runs them point by point)."""
        c, s1, task = _cfg_state()
        _, s2, _ = _cfg_state()
        cfg = dataclasses.replace(c, **over)
        jcfg = jrt.FLConfig(num_devices=K, grad_bound=25.0,
                            channel=JChannelConfig(num_devices=K), **over)
        for field, value in over.items():
            assert getattr(cfg, field) == getattr(jcfg, field) == value
        for run_batched, cfgs, states in (
                (rt.run_batched, [cfg, cfg], [s1, s2]),
                (jrt.run_batched, [jcfg, jcfg], [None, None])):
            with pytest.raises(ValueError, match="sequential"):
                run_batched(cfgs, states, task.grad_fn, task.batch_provider,
                            2)

    def test_round_counter_mismatch_raises(self):
        c, s1, task = _cfg_state()
        _, s2, _ = _cfg_state()
        s2.round = 5
        with pytest.raises(ValueError, match="round counter"):
            rt.run_batched([c, c], [s1, s2], task.grad_fn,
                           task.batch_provider, 2)

    def test_model_dim_mismatch_raises(self):
        c, s1, task = _cfg_state()
        _, s2, _ = _cfg_state()
        s2.model_dim += 1
        with pytest.raises(ValueError, match="model_dim"):
            rt.run_batched([c, c], [s1, s2], task.grad_fn,
                           task.batch_provider, 2)

    def test_empty_or_ragged_lists_raise(self):
        c, s, task = _cfg_state()
        for cfgs, states in (([], []), ([c, c], [s])):
            with pytest.raises(ValueError, match="equal, nonzero"):
                rt.run_batched(cfgs, states, task.grad_fn,
                               task.batch_provider, 2)

    def test_history_layout_and_states(self):
        c, s, task = _cfg_state()
        c2, s2, _ = _cfg_state(seed=1)
        states, hist = rt.run_batched([c, c2], [s, s2], task.grad_fn,
                                      task.batch_provider, 7,
                                      eval_fn=task.eval_fn, eval_every=5,
                                      chunk_size=3)
        assert hist["round"] == list(range(1, 8))
        assert hist["eval_round"] == [1, 5]
        for k in rt.DIAG_KEYS:
            assert hist[k].shape == (2, 7), k
        assert hist["gap"].shape == (2, 2)
        assert [st.round for st in states] == [7, 7]
        assert int(states[0].opt_state.step) == 7


class TestShardedLanes:
    """``run_batched(shard=True)`` / ``run_sweep(shard=True)`` over two
    CPU devices (the experiment axis: two lanes a device, each device its
    own engine): every lane bitwise its point's sequential run."""
    CPU2 = [torch.device("cpu")] * 2

    @pytest.fixture
    def sharded(self, monkeypatch):
        """The lane bounds of every sharded engine made."""
        made = []
        init = rt._ShardedChunks.__init__

        def spy(engine, engines, bounds):
            made.append(list(bounds))
            init(engine, engines, bounds)
        monkeypatch.setattr(rt._ShardedChunks, "__init__", spy)
        return made

    @pytest.mark.parametrize("name", ["ridge", "mnist_scenarios",
                                      "fedprox_mu"])
    def test_sharded_sweep_is_sequential_bitwise(self, sharded, name):
        from repro_torch.fl.clients import ClientConfig
        sweep = {
            "ridge": lambda: SweepSpec(ridge_spec(), {
                "seed": (0, 1), "noise_var": (1e-7, 1e-6)}),
            "mnist_scenarios": lambda: SweepSpec(mnist_spec(
                participation=0.5, server_opt="adamw", local_steps=2,
                local_lr=0.05), {"seed": (0, 1)}),
            "fedprox_mu": lambda: SweepSpec(mnist_spec(
                local_steps=2, local_lr=0.05,
                client=ClientConfig(algo="fedprox")),
                {"client.mu": (0.0, 0.5)}),
        }[name]()
        res = run_sweep(sweep, 4, device="cpu", devices=self.CPU2)
        per = sweep.size // 2
        assert sharded == [[(0, per), (per, sweep.size)]]
        seq = run_sweep(sweep, 4, vectorized=False, device="cpu")
        for key in seq.history:
            np.testing.assert_array_equal(res.history[key],
                                          seq.history[key], err_msg=key)
        assert res.params_digests == seq.params_digests

    def test_run_batched_lanes_are_their_runs(self, sharded):
        cfgs, states, task = [], [], None
        for seed, nv in ((0, 1e-7), (1, 1e-6), (2, 0.0), (3, 1e-7)):
            c, s, task = _cfg_state(
                seed=seed, channel=ChannelConfig(num_devices=K,
                                                 channel_mean=1e-3,
                                                 noise_var=nv))
            cfgs.append(c)
            states.append(s)
        states, hist = rt.run_batched(
            cfgs, states, task.grad_fn, task.batch_provider, 5,
            eval_fn=task.eval_fn, eval_every=4, chunk_size=3,
            devices=self.CPU2)
        assert sharded == [[(0, 2), (2, 4)]]
        for e, c in enumerate(cfgs):
            _, s, _ = _cfg_state(seed=c.seed, channel=c.channel)
            s, h = rt.run(c, s, task.grad_fn, task.batch_provider, 5,
                          eval_fn=task.eval_fn, eval_every=4, chunk_size=3)
            for k in rt.DIAG_KEYS:
                assert hist[k][e].tolist() == list(h[k]), (e, k)
            assert hist["gap"][e].tolist() == list(h["gap"]), e
            for k in s.params:
                assert torch.equal(states[e].params[k], s.params[k]), e
            assert int(states[e].opt_state.step) == 5

    @pytest.mark.parametrize("devices,lanes", [([torch.device("cpu")], 4),
                                               (CPU2, 3)],
                             ids=["one_device", "nondividing"])
    def test_unsharded_where_the_mesh_does_not_apply(self, sharded, devices,
                                                     lanes):
        sweep = SweepSpec(ridge_spec(), {"seed": tuple(range(lanes))})
        res = run_sweep(sweep, 4, device="cpu", devices=devices)
        plain = run_sweep(sweep, 4, device="cpu", shard=False)
        assert sharded == []
        assert res.params_digests == plain.params_digests
        for key in plain.history:
            np.testing.assert_array_equal(res.history[key],
                                          plain.history[key])

    def test_another_device_needs_the_task_there(self):
        c, s1, task = _cfg_state()
        _, s2, _ = _cfg_state(seed=1)
        with pytest.raises(ValueError, match="task_on"):
            rt.run_batched([c, c], [s1, s2], task.grad_fn,
                           task.batch_provider, 2,
                           devices=[torch.device("cpu"),
                                    torch.device("meta")])


def _reference_ridge():
    """The reference's Case-II ridge task and a (seed x noise_var) grid of
    its states."""
    data = JDataSpec(dataset="ridge", split="iid", num_train=200, dim=8,
                     batch_size=16, seed=3)
    task = jbuild_task(data, JModelSpec(kind="ridge"), K)
    cfgs = [jrt.FLConfig(num_devices=K, scheme="normalized", case="II",
                         eta=0.01, backend="kernels", grad_bound=25.0,
                         s_target=0.995, smoothness_L=2.0,
                         strong_convexity_M=0.5, seed=seed,
                         channel=JChannelConfig(num_devices=K,
                                                channel_mean=1e-3,
                                                noise_var=nv))
            for seed in (0, 1) for nv in (1e-7, 1e-6)]
    return task, cfgs


def test_batched_matches_the_reference_run_batched(monkeypatch):
    """The port's run_batched against the reference's on the same setup
    states, batches and per-lane noise (the reference's draws, staged in
    place of the port's own), at fp32 tolerance."""
    jtask, jcfgs = _reference_ridge()
    rounds = 6
    jstates = [jrt.setup(c, jtask.params0, jtask.model_dim) for c in jcfgs]
    port_states = [interop.state_from_jax(
        jax.tree_util.tree_map(np.asarray, st.params), st.h, st.h_hat, st.b,
        st.a, st.eta0, 0, model_dim=st.model_dim, device="cpu")
        for st in jstates]
    zeros = jax.tree_util.tree_map(lambda l: jnp.zeros(l.shape, jnp.float32),
                                   jtask.params0)
    noise = {(c.seed, c.channel.noise_var, t): np.array(ravel_pytree(
        jschemes.add_channel_noise(
            zeros, jax.random.fold_in(jax.random.PRNGKey(c.seed + 1), t),
            c.channel.noise_var))[0])
        for c in jcfgs for t in range(1, rounds + 1)}
    batches = {t: np.array(jtask.batch_provider(t)[0])
               for t in range(1, rounds + 1)}
    _, want = jrt.run_batched(jcfgs, jstates, jtask.grad_fn,
                              jtask.batch_provider, rounds,
                              eval_fn=jtask.eval_fn, eval_every=5,
                              chunk_size=4, shard=False)

    def reference_noise(lanes, shapes, ts, noise_provider=None):
        return torch.stack([torch.stack([torch.from_numpy(noise[(
            lane.cfg.seed, lane.cfg.channel.noise_var, t)]) for lane in lanes])
            for t in ts])

    monkeypatch.setattr(rt, "_stage_noise", reference_noise)
    c = jtask.constants
    task = tasks.ridge_task(
        c["x"], c["y"], FederatedSplit(tuple(c["split"].indices)),
        port_states[0].params, lam=0.1, batch_size=16, provider_seed=0,
        device="cpu")
    cfgs = [rt.FLConfig(num_devices=K, scheme="normalized", case="II",
                        eta=0.01, backend="kernels", grad_bound=25.0,
                        s_target=0.995, smoothness_L=2.0,
                        strong_convexity_M=0.5, seed=jc.seed,
                        channel=ChannelConfig(
                            num_devices=K, channel_mean=1e-3,
                            noise_var=jc.channel.noise_var))
            for jc in jcfgs]
    _, got = rt.run_batched(cfgs, port_states, task.grad_fn,
                            lambda t: (torch.from_numpy(batches[t]),),
                            rounds, eval_fn=task.eval_fn, eval_every=5,
                            chunk_size=4)
    assert got["round"] == want["round"]
    assert got["eval_round"] == want["eval_round"]
    for key in rt.DIAG_KEYS + ("gap", "loss"):
        # fp32 gradients and K-way sums associated differently by XLA and
        # PyTorch, compounded over the rounds (the runtime parity
        # tolerance, tests/test_torch_runtime.py)
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-9, err_msg=key)


class TestCaches:
    def test_cache_info_shape(self):
        info = rt.cache_info()
        assert info["cache_size"] == rt.ENGINE_CACHE_SIZE >= 1
        assert set(info["builders"]) == {"round_step", "run_chunk",
                                         "run_chunk_batched"}
        for stats in info["builders"].values():
            assert {"hits", "misses", "maxsize", "currsize"} <= set(stats)

    def test_repeat_sweep_captures_nothing(self):
        sweep = SweepSpec(ridge_spec(), {"scheme": ("normalized",
                                                    "benchmark1"),
                                         "seed": (0, 1)})
        rt.clear_compile_caches()
        rt.cache_info()
        first = run_sweep(sweep, 4, device="cpu")
        delta = rt.cache_info()["traces_delta"]
        assert delta["run_chunk_batched"] == 2 and delta["run_chunk"] == 0
        again = run_sweep(sweep, 4, device="cpu")
        assert set(rt.cache_info()["traces_delta"].values()) == {0}
        assert first.params_digests == again.params_digests

    @pytest.mark.parametrize("env,module,attr", [
        ("REPRO_ENGINE_CACHE_SIZE", "repro_torch.fed.runtime",
         "ENGINE_CACHE_SIZE"),
        ("REPRO_TASK_CACHE_SIZE", "repro_torch.fl.tasks", "TASK_CACHE_SIZE"),
    ])
    def test_cache_size_env_override(self, env, module, attr):
        code = (f"import os; os.environ[{env!r}] = '7'; "
                f"import {module} as m; "
                f"assert m.{attr} == 7; "
                "from repro_torch.fed import runtime; "
                "from repro_torch.fl import tasks; "
                "assert runtime._make_run_chunk.cache_info().maxsize == "
                "runtime.ENGINE_CACHE_SIZE; "
                "assert tasks.task_cache_info()['maxsize'] == "
                "tasks.TASK_CACHE_SIZE; "
                "assert runtime.cache_info()['cache_size'] == "
                "runtime.ENGINE_CACHE_SIZE; print('ENV_OK')")
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                           cwd=str(ROOT), timeout=120)
        assert "ENV_OK" in r.stdout, r.stderr[-2000:]

    def test_task_cache_info_and_ridge_split_normalisation(self):
        spec = ridge_spec()
        before = tasks.task_cache_info()
        assert {"hits", "misses", "maxsize", "currsize"} <= set(before)
        a = tasks.build_task(spec.data, spec.model, K, "cpu")
        b = tasks.build_task(dataclasses.replace(spec.data,
                                                 split="dirichlet"),
                             spec.model, K, torch.device("cpu"))
        assert a is b
        assert tasks.task_cache_info()["hits"] >= before["hits"] + 1
