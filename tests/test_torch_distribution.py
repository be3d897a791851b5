"""The FL-device mesh of the port (``repro_torch.distribution``) against the
JAX package's ``repro.distribution``, on the CPU:

* ``fold_shards`` with add, min and max against the reference's on the
  same numpy stacks, bitwise; ``stack_shards`` and the fold on a carry;
* ``device_mesh``: a bad count, ``REPRO_FL_MESH=emulate``, no group;
* ``schemes.transform(extra_scale=, out_dtype=)`` and ``tree_sq_norm``
  against the reference;
* in one subprocess of four ``gloo`` ranks (``torch.multiprocessing``):
  ``ota_psum`` (plain and kernel statistics) and ``ota.aggregate(backend=
  "mesh")`` for every scheme, noiseless and noisy with the same injected
  noise, with and without a CSI estimate, against the port's and the
  reference's vmap ``aggregate`` on the same inputs at the reference's
  cross-backend tolerance (``tests/test_backends.py``: rtol 2e-4, atol
  2e-5), every rank holding the same result; and the FL round on the
  ``mesh`` backend, scan against python bitwise and against the vmap
  round.

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
from repro.distribution import ota_collectives as jcoll
from repro_torch.core import ota, schemes
from repro_torch.distribution import ota_collectives as coll
from repro_torch.distribution import sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
SHAPES = {"p0": (9, 5), "p1": (33,), "p2": (4, 3, 2)}
A, GRAD_BOUND, NOISE_VAR = 1.3, 7.5, 2.5e-3
NKEY = jax.random.fold_in(jax.random.PRNGKey(11), 9)
# the reference's cross-backend tolerance (tests/test_backends.py): the
# superposition summed over ranks against a tensordot over the stack
BACKEND_TOL = dict(rtol=2e-4, atol=2e-5)
SCHEMES = jschemes.names()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one thread runs them as fast.  Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the cross-shard fold


FOLD_OPS = {"add": (torch.add, jax.lax.add),
            "min": (torch.minimum, jax.lax.min),
            "max": (torch.maximum, jax.lax.max)}


@pytest.mark.parametrize("shape", [(2, 7), (4, 33), (5, 3, 4), (3,)])
@pytest.mark.parametrize("op", sorted(FOLD_OPS))
def test_fold_shards_is_the_reference_fold(op, shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., :1] *= 1e6                       # a sum that rounds
    tree = {"acc": x, "side": {"m": x * 0.5}}
    top, jop = FOLD_OPS[op]
    got = coll.fold_shards({k: (torch.from_numpy(v) if k == "acc" else
                                {"m": torch.from_numpy(v["m"])})
                            for k, v in tree.items()}, top)
    want = jcoll.fold_shards(jax.tree_util.tree_map(jnp.asarray, tree), jop)
    np.testing.assert_array_equal(got["acc"].numpy(), np.asarray(want["acc"]))
    np.testing.assert_array_equal(got["side"]["m"].numpy(),
                                  np.asarray(want["side"]["m"]))


def test_fold_shards_is_a_left_fold_of_stacked_carries():
    """``stack_shards`` of per-shard carries, then the fold: ((c0 + c1) +
    c2) leaf by leaf, the same structure back."""
    rng = np.random.default_rng(0)
    carries = [{"acc": torch.from_numpy(rng.standard_normal(6).astype(
        np.float32) * 10.0 ** i), "hb": torch.tensor(float(i) + 0.1),
        "side": {}} for i in range(3)]
    stacked = coll.stack_shards(carries)
    assert stacked["acc"].shape == (3, 6) and stacked["hb"].shape == (3,)
    got = coll.fold_shards(stacked)
    want = (carries[0]["acc"] + carries[1]["acc"]) + carries[2]["acc"]
    assert torch.equal(got["acc"], want)
    assert torch.equal(got["hb"], (carries[0]["hb"] + carries[1]["hb"])
                       + carries[2]["hb"])
    assert got["side"] == {}


# ---------------------------------------------------------------------------
# the mesh handle


class TestDeviceMesh:
    def test_rejects_bad_count(self):
        with pytest.raises(ValueError, match=">= 1"):
            sharding.device_mesh(0)

    def test_falls_back_without_a_group(self):
        assert not torch.distributed.is_initialized()
        assert sharding.device_mesh(4) is None
        assert sharding.device_mesh(1) is None     # 1 shard: plain stream

    def test_emulate_env_forces_fallback(self, monkeypatch):
        monkeypatch.setenv(sharding._EMULATE_ENV, "emulate")
        assert sharding.device_mesh(2) is None
        assert sharding._EMULATE_ENV == "REPRO_FL_MESH"

    def test_shard_device_axis_takes_the_rank_row(self):
        mesh = sharding.DeviceMesh(group=None, size=2, rank=1)
        tree = {"x": torch.arange(12.0).reshape(2, 3, 2),
                "c": torch.tensor(5.0),
                "rows": [torch.arange(4).reshape(2, 2)]}
        got = sharding.shard_device_axis(tree, mesh)
        assert torch.equal(got["x"], tree["x"][1])
        assert torch.equal(got["c"], tree["c"])
        assert torch.equal(got["rows"][0], torch.tensor([2, 3]))
        assert mesh.axis_name == sharding.FL_DEVICE_AXIS == "fldev"


def test_aggregate_mesh_without_a_group_raises():
    cfg = ota.OTAConfig(backend="mesh")
    with pytest.raises(ValueError, match="start K ranks"):
        ota.aggregate(cfg, {"w": torch.ones((K, 3))}, torch.ones(K),
                      torch.ones(K))


@pytest.mark.parametrize("scheme", ["benchmark1", "clipped"])
def test_ota_psum_requires_grad_bound(scheme):
    """The reference's validation (tests/test_backends.py::
    TestGradBoundValidation): raised before any collective."""
    with pytest.raises(ValueError, match="grad_bound"):
        coll.ota_psum({"w": torch.ones(4)}, scheme=scheme, group=None,
                      h=torch.ones(4), b=torch.ones(4), a=1.0, noise_var=0.0)


def test_ota_psum_rejects_unknown_stats_impl():
    with pytest.raises(ValueError, match="stats_impl"):
        coll.ota_psum({"w": torch.ones(4)}, scheme="normalized", group=None,
                      h=torch.ones(4), b=torch.ones(4), a=1.0, noise_var=0.0,
                      stats_impl="jnp")


# ---------------------------------------------------------------------------
# the transform with h_k b_k folded in, and the norm helper


@pytest.mark.parametrize("scheme", [s for s in SCHEMES
                                    if not jschemes.get(s).baseline])
def test_transform_extra_scale_matches_reference(scheme):
    rng = np.random.default_rng(7)
    g = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in SHAPES.items()}
    extra = np.float32(0.37)
    sch, jsch = schemes.get(scheme), jschemes.get(scheme)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    got = schemes.transform(
        sch, tg, schemes.compute_stats(tg, sch, batched=False), GRAD_BOUND,
        batched=False, extra_scale=torch.tensor(extra),
        out_dtype=torch.float32)
    want = jschemes.transform(
        jsch, jg, jschemes.compute_stats(jg, jsch, batched=False), GRAD_BOUND,
        batched=False, extra_scale=jnp.asarray(extra), out_dtype=jnp.float32)
    for k in SHAPES:
        assert got[k].dtype == torch.float32
        # elementwise products of statistics summed in other orders
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-6, atol=1e-7, err_msg=k)


def test_transform_defaults_keep_the_leaf_dtype():
    sch = schemes.get("normalized")
    g = {"w": torch.randn(3, 8, generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64)}
    st = schemes.compute_stats(g, sch, batched=True)
    assert schemes.transform(sch, g, st, batched=True)["w"].dtype == \
        torch.float64
    assert schemes.transform(sch, g, st, batched=True,
                             out_dtype=torch.float32)["w"].dtype == \
        torch.float32


def test_tree_sq_norm_matches_flat_norm():
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": (torch.ones(4, dtype=torch.bfloat16),
                  -2.0 * torch.ones(2, 2))}
    flat = np.concatenate([np.arange(6.0), np.ones(4), -2.0 * np.ones(4)])
    assert float(coll.tree_sq_norm(tree)) == pytest.approx(
        float(np.sum(flat * flat)), rel=1e-6)
    jtree = {"a": jnp.arange(6.0).reshape(2, 3),
             "b": (jnp.ones((4,), jnp.bfloat16), -2.0 * jnp.ones((2, 2)))}
    assert float(coll.tree_sq_norm(tree)) == float(jcoll.tree_sq_norm(jtree))


# ---------------------------------------------------------------------------
# four gloo ranks: the mesh backend against the vmap backend of both packages


def _inputs():
    rng = np.random.default_rng(0)
    g = {n: rng.standard_normal((K,) + s).astype(np.float32)
         for n, s in SHAPES.items()}
    h = (np.abs(rng.standard_normal(K)) + 0.1).astype(np.float32)
    b = (np.abs(rng.standard_normal(K)) + 0.5).astype(np.float32)
    h_hat = (h * (1.0 + 0.1 * rng.standard_normal(K))).astype(np.float32)
    zeros = {n: jnp.zeros(s, jnp.float32) for n, s in SHAPES.items()}
    z, _ = ravel_pytree(jschemes.add_channel_noise(zeros, NKEY, NOISE_VAR))
    return g, h, b, h_hat, np.array(z)


RANKS_SCRIPT = r'''
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 4


def aggregates(inp):
    from repro_torch.core import ota, schemes
    from repro_torch.distribution import ota_collectives as coll
    g = {k[2:]: torch.from_numpy(v) for k, v in inp.items()
         if k.startswith("g_")}
    h, b, h_hat, z = (torch.from_numpy(inp[k])
                      for k in ("h", "b", "h_hat", "z"))
    rank = dist.get_rank()
    row = {k: v[rank] for k, v in g.items()}
    out = {}
    for scheme in schemes.names():
        for noisy in (False, True):
            for est in (False, True):
                tag = f"{scheme}/{int(noisy)}/{int(est)}"
                kw = dict(scheme=scheme, group=dist.group.WORLD, h=h, b=b,
                          a=float(inp["a"]),
                          noise_var=float(inp["noise_var"]) if noisy else 0.0,
                          noise=z if noisy else None,
                          grad_bound=float(inp["grad_bound"]),
                          h_hat=h_hat if est else None)
                out["psum/" + tag] = coll.ota_psum(row, **kw)
                out["psum_kernels/" + tag] = coll.ota_psum(
                    row, stats_impl="kernels", **kw)
                cfg = ota.OTAConfig(
                    scheme=scheme, a=float(inp["a"]),
                    noise_var=float(inp["noise_var"]) if noisy else 0.0,
                    grad_bound=float(inp["grad_bound"]), noiseless=not noisy,
                    backend="mesh")
                out["mesh/" + tag] = ota.aggregate(
                    cfg, g, h, b, h_hat=h_hat if est else None,
                    noise=z if noisy else None)
        # one noise stream on every rank: a CPU generator from one seed
        cfg = ota.OTAConfig(scheme=scheme, a=float(inp["a"]),
                            noise_var=float(inp["noise_var"]),
                            grad_bound=float(inp["grad_bound"]),
                            backend="mesh")
        out["mesh_gen/" + scheme] = ota.aggregate(
            cfg, g, h, b, generator=torch.Generator().manual_seed(5))
    return out


def fl_runs():
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.fed import runtime
    d = 6
    x = np.random.default_rng(3).standard_normal((48, d)).astype(np.float32)
    y = x @ np.linspace(0.5, 1.5, d).astype(np.float32)
    x, y = torch.from_numpy(x), torch.from_numpy(y)

    def grad_fn(params, batch):
        xb, yb = batch
        r = xb @ params["w"] - yb
        return {"w": xb.T @ r / r.shape[0]}

    def provider(t):
        idx = np.random.default_rng([5, t]).integers(0, 48, (RANKS, 6))
        idx = torch.from_numpy(idx)
        return x[idx], y[idx]

    out = {}
    for name, backend, driver in (("mesh_scan", "mesh", "scan"),
                                  ("mesh_python", "mesh", "python"),
                                  ("vmap", "vmap", "scan")):
        cfg = runtime.FLConfig(
            num_devices=RANKS, scheme="benchmark2", case="I", seed=0,
            grad_bound=10.0, backend=backend,
            channel=ChannelConfig(num_devices=RANKS, noise_var=1e-6))
        st = runtime.setup(cfg, {"w": torch.zeros(d)}, d)
        _, hist = runtime.run(cfg, st, grad_fn, provider, 5, driver=driver,
                              chunk_size=2)
        out[name] = {"params": st.params["w"].clone(),
                     "hist": {k: list(hist[k]) for k in runtime.DIAG_KEYS}}
    return out


def worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    res = {"aggregates": aggregates(inp), "fl": fl_runs()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out_dir = sys.argv[1]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(worker, args=(port, out_dir), nprocs=RANKS)
    print("RANKS_OK")
'''


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every rank's results, from one subprocess that spawns four ``gloo``
    ranks on 127.0.0.1; each rank reads the inputs made here."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    g, h, b, h_hat, z = _inputs()
    np.savez(tmp / "inputs.npz", h=h, b=b, h_hat=h_hat, z=z, a=A,
             noise_var=NOISE_VAR, grad_bound=GRAD_BOUND,
             **{f"g_{k}": v for k, v in g.items()})
    script = tmp / "ranks.py"
    script.write_text(textwrap.dedent(RANKS_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(tmp)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0 and "RANKS_OK" in r.stdout, r.stderr[-4000:]
    return [torch.load(tmp / f"rank{i}.pt", weights_only=False)
            for i in range(K)]


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(want[k], np.float32),
                                   **BACKEND_TOL, err_msg=f"{what} {k}")


def _vmap_both(scheme, noisy, est):
    """The port's and the reference's vmap aggregate on the same inputs."""
    g, h, b, h_hat, z = _inputs()
    kw = dict(scheme=scheme, a=A, noise_var=NOISE_VAR if noisy else 0.0,
              grad_bound=GRAD_BOUND, noiseless=not noisy)
    port = ota.aggregate(
        ota.OTAConfig(**kw), {k: torch.from_numpy(v) for k, v in g.items()},
        torch.from_numpy(h), torch.from_numpy(b),
        h_hat=torch.from_numpy(h_hat) if est else None,
        noise=torch.from_numpy(z) if noisy else None)
    ref = jota.aggregate(jota.OTAConfig(**kw),
                         {k: jnp.asarray(v) for k, v in g.items()},
                         jnp.asarray(h), jnp.asarray(b), NKEY,
                         h_hat=jnp.asarray(h_hat) if est else None)
    return port, ref


@pytest.mark.parametrize("est", [False, True], ids=["csi", "h_hat"])
@pytest.mark.parametrize("noisy", [False, True], ids=["noiseless", "noisy"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_mesh_backend_matches_vmap(four_ranks, scheme, noisy, est):
    """``ota_psum`` (plain and kernel statistics) and ``aggregate(backend=
    "mesh")`` on four ranks against both packages' vmap aggregate, and the
    same bits on every rank."""
    port, ref = _vmap_both(scheme, noisy, est)
    tag = f"{scheme}/{int(noisy)}/{int(est)}"
    for kind in ("psum", "psum_kernels", "mesh"):
        got = four_ranks[0]["aggregates"][f"{kind}/{tag}"]
        _close(got, port, f"{kind} {tag} vs port vmap")
        _close(got, ref, f"{kind} {tag} vs reference vmap")
        for rank in range(1, K):
            other = four_ranks[rank]["aggregates"][f"{kind}/{tag}"]
            assert all(torch.equal(other[k], got[k]) for k in got), \
                (kind, tag, rank)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_mesh_backend_draws_the_vmap_noise(four_ranks, scheme):
    """One CPU generator from one seed on every rank: the mesh aggregate
    adds the noise the vmap aggregate draws from the same seed."""
    g, h, b, _, _ = _inputs()
    want = ota.aggregate(
        ota.OTAConfig(scheme=scheme, a=A, noise_var=NOISE_VAR,
                      grad_bound=GRAD_BOUND),
        {k: torch.from_numpy(v) for k, v in g.items()}, torch.from_numpy(h),
        torch.from_numpy(b), generator=torch.Generator().manual_seed(5))
    got = four_ranks[0]["aggregates"][f"mesh_gen/{scheme}"]
    _close(got, want, scheme)
    for rank in range(1, K):
        other = four_ranks[rank]["aggregates"][f"mesh_gen/{scheme}"]
        assert all(torch.equal(other[k], got[k]) for k in got), rank


def test_mesh_round_scan_is_python(four_ranks):
    """The FL round on the mesh backend (the dense round, one rank a
    device): both drivers run it eagerly and give the same bits, on every
    rank."""
    for res in four_ranks:
        scan, python = res["fl"]["mesh_scan"], res["fl"]["mesh_python"]
        assert torch.equal(scan["params"], python["params"])
        assert scan["hist"] == python["hist"]
        assert torch.equal(scan["params"], four_ranks[0]["fl"]["mesh_scan"]
                           ["params"])


def test_mesh_round_matches_vmap_round(four_ranks):
    """Five rounds on the mesh backend against the vmap backend from the
    same setup: the superposition summed over ranks against a tensordot,
    within the cross-backend tolerance."""
    fl = four_ranks[0]["fl"]
    np.testing.assert_allclose(fl["mesh_scan"]["params"].numpy(),
                               fl["vmap"]["params"].numpy(), **BACKEND_TOL)
    for k in ("grad_norm_mean", "tx_energy", "update_norm", "eta",
              "num_participants"):
        np.testing.assert_allclose(fl["mesh_scan"]["hist"][k],
                                   fl["vmap"]["hist"][k], rtol=2e-4,
                                   err_msg=k)
