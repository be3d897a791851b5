"""The sharded streaming round of the port (``FLConfig.device_mesh`` and
``OTAConfig.device_mesh``), on the CPU.

``device_mesh = D`` fixes the order of the round's sums -- each of D
contiguous runs of K-blocks folded from a zero carry, then one fixed left
fold of the D carries (``distribution.ota_collectives.fold_shards``) -- not
a placement.  Checked here:

* the reference's validation, spec override, emulated-path and OTA-level
  cases (``tests/test_sharded_streaming.py``, the same configs and
  tolerances: ``device_mesh = 1`` bitwise the plain stream, D = 2 within
  rtol 2e-5 of it) and its sweep fallback;
* the port against the JAX package's own emulated ``device_mesh = 2`` run
  (sgd and scaffold) from the reference's setup, batches and noise, at the
  stream tolerance;
* in one subprocess of two ``gloo`` ranks (``torch.multiprocessing``, the
  CPU): the physical round (a rank a shard, the carries gathered) bitwise
  the emulated round for {vmap, kernels} x {fixed, block fading} x {sgd,
  scaffold} and an active-gather scaffold case, the ranks' results the
  same, and a run saved after 2 rounds on the group resumed emulated
  bitwise the unbroken 4-round run.

torch runs on one thread in this file and in the ranks.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import ota as jota
from repro.core import schemes as jschemes
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.fed import runtime as jruntime
from repro.fl import clients as jclients
from repro_torch import interop
from repro_torch.core import ota
from repro_torch.core.channel import ChannelConfig
from repro_torch.fed import runtime
from repro_torch.fl import (DataSpec, EvalSpec, ExperimentSpec, SweepSpec,
                            run_sweep)
from repro_torch.fl import clients

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sharded vs plain stream: the same per-device terms re-associated into
# shard partials (the reference's tolerance, tests/test_sharded_streaming.py)
SHARD_TOL = dict(rtol=2e-5, atol=1e-7)
# port vs reference over rounds: blocked fp32 sums in other orders,
# compounding through the round map (tests/test_torch_streaming.py)
STREAM_TOL = dict(rtol=3e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors and many small ops: one thread runs them as fast and
    does not stall on a loaded machine.  Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fl(pkg, **kw):
    cls, ccls = ((runtime.FLConfig, ChannelConfig) if pkg == "port"
                 else (jruntime.FLConfig, JChannelConfig))
    return cls(num_devices=8, channel=ccls(num_devices=8), grad_bound=5.0,
               **kw)


# ---------------------------------------------------------------------------
# config validation (both packages, the same errors)


class TestDeviceMeshValidation:
    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_fl_device_mesh_requires_k_block(self, pkg):
        with pytest.raises(ValueError, match="k_block"):
            _fl(pkg, device_mesh=2)

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_fl_device_mesh_must_be_positive(self, pkg):
        with pytest.raises(ValueError, match=">= 1"):
            _fl(pkg, k_block=2, device_mesh=0)

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_fl_device_mesh_must_divide_blocks(self, pkg):
        # K = 8, k_block = 2: 4 blocks, which 3 shards cannot split evenly
        with pytest.raises(ValueError, match="device_mesh"):
            _fl(pkg, k_block=2, device_mesh=3)

    def test_fl_device_mesh_builds(self):
        for dm in (1, 2, 4):
            assert _fl("port", k_block=2, device_mesh=dm).device_mesh == dm
        assert _fl("port", k_block=2, device_mesh=2).sharded()
        assert not _fl("port", k_block=2, device_mesh=1).sharded()

    @pytest.mark.parametrize("cls", [ota.OTAConfig, jota.OTAConfig],
                             ids=["port", "ref"])
    def test_ota_device_mesh_requires_k_block(self, cls):
        with pytest.raises(ValueError, match="k_block"):
            cls(scheme="normalized", a=1.0, noise_var=0.0, grad_bound=5.0,
                device_mesh=2)

    def test_run_batched_rejects_device_mesh(self):
        cfg = _fl("port", k_block=2, device_mesh=2)
        with pytest.raises(ValueError, match="sequential"):
            runtime.run_batched([cfg, cfg], [None, None], lambda p, b: p,
                                lambda t: None, 1)

    def test_device_mesh_is_structural(self):
        assert "device_mesh" in runtime.STRUCTURAL_FL_FIELDS
        assert "device_mesh" in ota.STRUCTURAL_OTA_FIELDS
        assert ota.STRUCTURAL_OTA_FIELDS == jota.STRUCTURAL_OTA_FIELDS


def _ridge_fl(**kw):
    return runtime.FLConfig(num_devices=8, channel=ChannelConfig(
        num_devices=8), grad_bound=5.0, k_block=2, **kw)


class TestSpecOverride:
    def test_device_mesh_override_flows_into_config(self):
        spec = ExperimentSpec(
            fl=_ridge_fl(), data=DataSpec(dataset="ridge", num_train=64,
                                          dim=4, batch_size=8),
            device_mesh=2)
        assert spec.fl_config().device_mesh == 2

    def test_invalid_override_fails_at_spec_time(self):
        with pytest.raises(ValueError, match="device_mesh"):
            ExperimentSpec(
                fl=_ridge_fl(), data=DataSpec(dataset="ridge", num_train=64,
                                              dim=4, batch_size=8),
                device_mesh=3)


# ---------------------------------------------------------------------------
# the emulated path: sharded against the plain stream


def _tiny_setup(algo="sgd", participation=1.0, backend="vmap",
                device_mesh=None):
    """The reference's ``_tiny_setup``: K = 8, a 5-weight ridge model,
    k_block = 2, noise 1e-6; the data made from a seed with numpy."""
    k, d = 8, 5
    cfg = runtime.FLConfig(
        num_devices=k, case="I", seed=0, grad_bound=5.0, backend=backend,
        k_block=2, device_mesh=device_mesh, participation=participation,
        channel=ChannelConfig(num_devices=k, noise_var=1e-6),
        client=clients.ClientConfig(algo=algo))
    x = np.random.default_rng(3).standard_normal((32, d)).astype(np.float32)
    y = x @ np.ones(d, np.float32) + np.float32(0.01)
    x, y = torch.from_numpy(x), torch.from_numpy(y)

    def grad_fn(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    def provider(t):
        idx = np.random.default_rng([4, t]).integers(0, 32, (k, 4))
        idx = torch.from_numpy(idx)
        return x[idx], y[idx]

    st = runtime.setup(cfg, {"w": torch.zeros(d)}, d)
    return cfg, st, grad_fn, provider


def _run3(**kw):
    cfg, st, gf, pr = _tiny_setup(**kw)
    _, hist = runtime.run(cfg, st, gf, pr, 3, driver="scan", chunk_size=3)
    return st, hist


class TestEmulatedSharding:
    @pytest.mark.parametrize("backend", ["vmap", "kernels"])
    def test_device_mesh_one_is_plain_stream(self, backend):
        """device_mesh = 1 is the identity blocking: bitwise the plain
        stream, params and every diagnostic."""
        (a, ha), (b, hb) = (_run3(backend=backend, device_mesh=dm)
                            for dm in (None, 1))
        assert torch.equal(a.params["w"], b.params["w"])
        assert all(ha[k] == hb[k] for k in runtime.DIAG_KEYS)

    @pytest.mark.parametrize("backend", ["vmap", "kernels"])
    def test_sharded_close_to_plain_stream(self, backend):
        """device_mesh = 2 re-associates block partials: within the
        reference's tolerance of the plain stream."""
        (a, ha), (b, hb) = (_run3(backend=backend, device_mesh=dm)
                            for dm in (None, 2))
        np.testing.assert_allclose(b.params["w"].numpy(),
                                   a.params["w"].numpy(), **SHARD_TOL)
        # min and max fold exactly; the participant count is exact
        for k in ("grad_norm_min", "grad_norm_max", "num_participants",
                  "eta"):
            assert ha[k] == hb[k], k

    def test_sharded_deterministic_across_reruns(self):
        (a, ha), (b, hb) = (_run3(device_mesh=4) for _ in range(2))
        assert torch.equal(a.params["w"], b.params["w"])
        assert ha == hb

    def test_sharded_scaffold_close_to_plain(self):
        (a, _), (b, _) = (_run3(algo="scaffold", device_mesh=dm)
                          for dm in (None, 2))
        np.testing.assert_allclose(b.params["w"].numpy(),
                                   a.params["w"].numpy(), **SHARD_TOL)

    def test_sharded_masked_close_to_plain(self):
        (a, _), (b, _) = (_run3(participation=0.5, device_mesh=dm)
                          for dm in (None, 2))
        np.testing.assert_allclose(b.params["w"].numpy(),
                                   a.params["w"].numpy(), **SHARD_TOL)

    def test_scan_matches_python_bitwise(self):
        runs = []
        for driver in ("scan", "python"):
            cfg, st, gf, pr = _tiny_setup(algo="scaffold", device_mesh=2)
            _, hist = runtime.run(cfg, st, gf, pr, 3, driver=driver,
                                  chunk_size=2)
            runs.append((st, hist))
        (a, ha), (b, hb) = runs
        assert torch.equal(a.params["w"], b.params["w"])
        assert torch.equal(a.client_state["dev"]["w"],
                           b.client_state["dev"]["w"])
        assert all(ha[k] == hb[k] for k in runtime.DIAG_KEYS)


class TestOTALevelSharding:
    def _inputs(self):
        k, n = 8, 33
        rng = np.random.default_rng(1)
        g = rng.standard_normal((k, n)).astype(np.float32)
        h = np.abs(rng.standard_normal(k)).astype(np.float32)
        return g, h, np.ones(k, np.float32)

    @pytest.mark.parametrize("backend", ["vmap", "kernels"])
    def test_aggregate_device_mesh_close_to_streaming(self, backend):
        """Standalone ota.aggregate with device_mesh: the blocked-and-folded
        sum is within the reference's tolerance of the plain streamed
        aggregate on both stacked backends, and of the reference's own
        sharded aggregate."""
        g, h, b = self._inputs()
        ys = []
        for dm in (None, 2):
            cfg = ota.OTAConfig(scheme="normalized", a=0.5, noise_var=0.0,
                                grad_bound=5.0, backend=backend, k_block=2,
                                device_mesh=dm)
            ys.append(ota.aggregate(cfg, {"w": torch.from_numpy(g)},
                                    torch.from_numpy(h), torch.from_numpy(b)))
        np.testing.assert_allclose(ys[1]["w"].numpy(), ys[0]["w"].numpy(),
                                   **SHARD_TOL, err_msg=backend)
        jcfg = jota.OTAConfig(scheme="normalized", a=0.5, noise_var=0.0,
                              grad_bound=5.0, backend="vmap", k_block=2,
                              device_mesh=2)
        want = jota.aggregate(jcfg, {"w": jnp.asarray(g)}, jnp.asarray(h),
                              jnp.asarray(b))
        np.testing.assert_allclose(ys[1]["w"].numpy(), np.asarray(want["w"]),
                                   **SHARD_TOL)

    def test_aggregate_device_mesh_must_divide_blocks(self):
        cfg = ota.OTAConfig(scheme="normalized", a=0.5, noise_var=0.0,
                            grad_bound=5.0, k_block=2, device_mesh=3)
        with pytest.raises(ValueError, match="device_mesh"):
            ota.aggregate(cfg, {"w": torch.ones((8, 4))}, torch.ones(8),
                          torch.ones(8))

    def test_kernels_aggregate_counts_no_launch_on_cpu(self):
        from repro_torch.kernels import ops
        g, h, b = self._inputs()
        cfg = ota.OTAConfig(scheme="benchmark2", a=0.5, noise_var=0.0,
                            backend="kernels", k_block=2, device_mesh=2)
        ops.reset_launch_counts()
        ota.aggregate(cfg, {"w": torch.from_numpy(g)}, torch.from_numpy(h),
                      torch.from_numpy(b))
        assert set(ops.LAUNCH_COUNTS.values()) == {0}


class TestSweepFallback:
    def test_device_mesh_group_runs_sequentially(self):
        """A sweep over a device_mesh spec must not reach run_batched (which
        rejects it): it runs point by point and completes, each point its
        own run."""
        from repro_torch.fl import Experiment
        spec = ExperimentSpec(
            fl=runtime.FLConfig(num_devices=8, case="II", eta=0.05,
                                channel=ChannelConfig(num_devices=8,
                                                      channel_mean=1e-3),
                                grad_bound=25.0, s_target=0.995,
                                smoothness_L=2.0, strong_convexity_M=0.5,
                                seed=0, k_block=2, scheme="normalized"),
            data=DataSpec(dataset="ridge", split="iid", num_train=64,
                          dim=4, batch_size=8, seed=1),
            eval=EvalSpec(enabled=False), chunk_size=2, device_mesh=2)
        res = run_sweep(SweepSpec(spec, {"seed": (0, 1)}), 2, device="cpu")
        assert res.history["grad_norm_mean"].shape[0] == 2
        import dataclasses
        e = Experiment(dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, seed=1)), device="cpu")
        e.run(2, evaluate=False)
        np.testing.assert_array_equal(res.history["update_norm"][1],
                                      e.history["update_norm"])


# ---------------------------------------------------------------------------
# the port against the JAX package's emulated device_mesh = 2 run


def _jtiny_setup(algo):
    """The reference's own ``_tiny_setup`` (tests/test_sharded_streaming.py)
    at device_mesh = 2."""
    k, d = 8, 5
    cfg = jruntime.FLConfig(
        num_devices=k, case="I", seed=0, grad_bound=5.0, backend="vmap",
        k_block=2, device_mesh=2,
        channel=JChannelConfig(num_devices=k, noise_var=1e-6),
        client=jclients.ClientConfig(algo=algo))
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.fold_in(key, 3), (32, d))
    y = x @ jnp.ones((d,)) + 0.01

    def grad_fn(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    def provider(t):
        kk = jax.random.fold_in(jax.random.fold_in(key, 4), t)
        idx = jax.random.randint(kk, (k, 4), 0, 32)
        return x[idx], y[idx]

    st = jruntime.setup(cfg, {"w": jnp.zeros((d,))}, d)
    return cfg, st, grad_fn, provider


@pytest.mark.parametrize("algo", ["sgd", "scaffold"])
def test_emulated_sharding_matches_reference(algo):
    """Three rounds of the port's sharded round (D = 2, vmap backend) from
    the reference's setup, batches and both slots' noise, against the JAX
    package's emulated run of the same config: params, client state and
    the diagnostics."""
    rounds = 3
    jcfg, jst, jgrad, jprov = _jtiny_setup(algo)
    setup = dict(params={"w": np.asarray(jst.params["w"])}, h=jst.h,
                 h_hat=jst.h_hat, b=jst.b, a=jst.a, eta0=jst.eta0,
                 model_dim=jst.model_dim)
    key = jax.random.PRNGKey(jcfg.seed + 1)
    zeros = {"w": jnp.zeros((5,), jnp.float32)}

    def noise(kk):
        z, _ = ravel_pytree(jschemes.add_channel_noise(
            zeros, kk, jcfg.channel.noise_var))
        return torch.from_numpy(np.array(z))

    noise1 = {t: noise(jax.random.fold_in(key, t))
              for t in range(1, rounds + 1)}
    noise2 = {t: noise(jax.random.fold_in(jax.random.fold_in(key, t),
                                          jruntime._SLOT_SALT))
              for t in range(1, rounds + 1)}
    batches = {t: tuple(torch.from_numpy(np.array(v)) for v in jprov(t))
               for t in range(1, rounds + 1)}
    _, jhist = jruntime.run(jcfg, jst, jgrad, jprov, rounds, driver="scan",
                            chunk_size=rounds)

    cfg = runtime.FLConfig(
        num_devices=8, case="I", seed=0, grad_bound=5.0, backend="vmap",
        k_block=2, device_mesh=2,
        channel=ChannelConfig(num_devices=8, noise_var=1e-6),
        client=clients.ClientConfig(algo=algo))
    state = interop.state_from_jax(
        setup["params"], setup["h"], setup["h_hat"], setup["b"], setup["a"],
        setup["eta0"], 0, model_dim=setup["model_dim"], device="cpu")

    def grad_fn(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    two_slot = clients.get(algo).num_slots == 2
    state, hist = runtime.run(
        cfg, state, grad_fn, lambda t: batches[t], rounds, driver="scan",
        chunk_size=rounds, noise_provider=lambda t: noise1[t],
        slot2_noise_provider=(lambda t: noise2[t]) if two_slot else None)
    np.testing.assert_allclose(state.params["w"].numpy(),
                               np.asarray(jst.params["w"]), **STREAM_TOL)
    if two_slot:
        for part in ("dev", "srv"):
            np.testing.assert_allclose(
                state.client_state[part]["w"].numpy(),
                np.asarray(jst.client_state[part]["w"]), **STREAM_TOL,
                err_msg=part)
    for k in runtime.DIAG_KEYS:
        np.testing.assert_allclose(hist[k], np.asarray(jhist[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)


# ---------------------------------------------------------------------------
# two gloo ranks: the physical round against the emulated round, bitwise

RANKS_SCRIPT = r'''
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

K, D, RANKS = 32, 7, 2


def cases():
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fl.clients import ClientConfig
    fixed = ChannelConfig(num_devices=K, noise_var=1e-6)
    fading = ChannelConfig(num_devices=K, noise_var=1e-6, block_fading=True)
    out = {}
    for backend in ("vmap", "kernels"):
        for ch_name, ch in (("fixed", fixed), ("fading", fading)):
            for algo in ("sgd", "scaffold"):
                out[f"{backend}/{ch_name}/{algo}"] = dict(
                    backend=backend, channel=ch,
                    client=ClientConfig(algo=algo))
    out["vmap/active_gather"] = dict(
        backend="vmap", channel=fixed, participation=0.5,
        participation_mode="fixed", active_gather=True,
        client=ClientConfig(algo="scaffold"))
    return out


def one_run(kw):
    from repro_torch.fed import runtime
    cfg = runtime.FLConfig(num_devices=K, case="I", seed=0, grad_bound=5.0,
                           k_block=4, device_mesh=RANKS, **kw)
    x = np.random.default_rng(3).standard_normal((64, D)).astype(np.float32)
    y = x @ np.ones(D, np.float32) + np.float32(0.01)
    x, y = torch.from_numpy(x), torch.from_numpy(y)

    def grad_fn(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    def provider(t):
        idx = np.random.default_rng([4, t]).integers(0, 64, (K, 4))
        idx = torch.from_numpy(idx)
        return x[idx], y[idx]

    st = runtime.setup(cfg, {"w": torch.zeros(D)}, D)
    _, hist = runtime.run(cfg, st, grad_fn, provider, 4, driver="scan",
                          chunk_size=4)
    cs = st.client_state
    return {"params": st.params["w"].clone(),
            "dev": None if cs is None or cs["dev"] is None
            else cs["dev"]["w"].clone(),
            "hist": {k: list(hist[k]) for k in runtime.DIAG_KEYS}}


def checkpoint(tmp, rank):
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fed import runtime
    from repro_torch.fl import (DataSpec, EvalSpec, Experiment,
                                ExperimentSpec, FLConfig)
    spec = ExperimentSpec(
        fl=FLConfig(num_devices=8, case="II", eta=0.05,
                    channel=ChannelConfig(num_devices=8, channel_mean=1e-3),
                    grad_bound=25.0, s_target=0.995, smoothness_L=2.0,
                    strong_convexity_M=0.5, seed=0, k_block=2,
                    scheme="normalized"),
        data=DataSpec(dataset="ridge", split="iid", num_train=64, dim=4,
                      batch_size=8, seed=1),
        eval=EvalSpec(enabled=False), chunk_size=2, device_mesh=RANKS)
    os.environ.pop("REPRO_FL_MESH", None)
    runtime.clear_compile_caches()
    unbroken = Experiment(spec, device="cpu").setup()
    unbroken.run(4)
    first = Experiment(spec, device="cpu").setup()
    first.run(2)
    path = os.path.join(tmp, f"ck{rank}")
    first.save(path)
    os.environ["REPRO_FL_MESH"] = "emulate"
    runtime.clear_compile_caches()
    resumed = Experiment(spec, device="cpu")
    resumed.load(path)
    at = resumed.state.round
    resumed.run(2)
    return {"unbroken": unbroken.params["w"].clone(),
            "resumed": resumed.params["w"].clone(), "loaded_round": at}


def worker(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    from repro_torch.distribution import sharding
    from repro_torch.fed import runtime
    res = {"mesh": tuple(sharding.device_mesh(RANKS)[1:3]), "cases": {}}
    for name, kw in cases().items():
        pair = {}
        for mode in ("physical", "emulated"):
            if mode == "emulated":
                os.environ["REPRO_FL_MESH"] = "emulate"
            else:
                os.environ.pop("REPRO_FL_MESH", None)
            runtime.clear_compile_caches()
            pair[mode] = one_run(kw)
        res["cases"][name] = pair
    res["checkpoint"] = checkpoint(out, rank)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(worker, args=(port, out), nprocs=RANKS)
    print("RANKS_OK")
'''

CASES = ["vmap/fixed/sgd", "vmap/fixed/scaffold", "vmap/fading/sgd",
         "vmap/fading/scaffold", "kernels/fixed/sgd", "kernels/fixed/scaffold",
         "kernels/fading/sgd", "kernels/fading/scaffold", "vmap/active_gather"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, from one subprocess that spawns two ``gloo``
    ranks on 127.0.0.1."""
    tmp = tmp_path_factory.mktemp("ranks")
    script = tmp / "ranks.py"
    script.write_text(textwrap.dedent(RANKS_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
    env.pop("REPRO_FL_MESH", None)
    r = subprocess.run([sys.executable, str(script), str(tmp)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0 and "RANKS_OK" in r.stdout, r.stderr[-4000:]
    return [torch.load(tmp / f"rank{i}.pt", weights_only=False)
            for i in range(2)]


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


class TestPhysicalParity:
    def test_each_rank_saw_its_mesh(self, two_ranks):
        assert [r["mesh"] for r in two_ranks] == [(2, 0), (2, 1)]
        assert sorted(two_ranks[0]["cases"]) == sorted(CASES)

    @pytest.mark.parametrize("case", CASES)
    def test_physical_is_emulated_bitwise(self, two_ranks, case):
        """A rank a shard (the carries and client-state rows gathered over
        the group) against the shards in turn in one process: the same
        params, client state and every diagnostic, on both ranks."""
        for rank, res in enumerate(two_ranks):
            phys, emu = (res["cases"][case][m]
                         for m in ("physical", "emulated"))
            assert torch.equal(phys["params"], emu["params"]), (case, rank)
            assert _same(phys["dev"], emu["dev"]), (case, rank)
            assert phys["hist"] == emu["hist"], (case, rank)
        a, b = (res["cases"][case]["physical"] for res in two_ranks)
        assert torch.equal(a["params"], b["params"]), case
        assert a["hist"] == b["hist"], case

    def test_checkpoint_portable_across_mesh_sizes(self, two_ranks):
        """A sharded run saved after 2 rounds on the group of 2 ranks
        resumes emulated, in one process, bitwise the unbroken 4-round run
        on the group: the checkpoint carries the math, not the
        placement."""
        for res in two_ranks:
            ck = res["checkpoint"]
            assert ck["loaded_round"] == 2
            assert torch.equal(ck["resumed"], ck["unbroken"])
