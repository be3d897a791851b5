"""The placement half of the port's ``distribution/`` against the JAX
package's ``repro.distribution.sharding``, on the CPU:

* ``param_specs``, ``cache_specs``, ``batch_specs`` and ``sanitize_spec``
  equal the reference's leaf for leaf, for every zoo config (reduced; the
  reference's shape trees from ``jax.eval_shape``);
* ``sanitize_spec`` warns once a distinct drop;
* ``experiment_mesh``'s None cases and ``require=True`` messages, and
  ``shard_experiment_axis``;
* the cut: ``init_sharded_params`` bitwise ``shard_params(init_params)``,
  ``gather_params`` its inverse, and the two cuts a hand-written
  tensor-parallel model needs where GSPMD could cut blindly: ``in_proj``'s
  two halves, and the attention cut by head (the kv projections whole
  where the kv heads do not divide), each held by its layer on an
  emulated mesh against the unsharded layer (fp32, ``1e-5 max|want|``).
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.distribution import sharding as jsh
from repro.models import transformer as JT
from repro_torch.configs import registry as reg
from repro_torch.distribution import sharding as sh
from repro_torch.distribution.tensor_parallel import run_ranks
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T

# every zoo config (xlstm's cells and seamless's encoder included: their
# leaves have the reference's specs, though they do not run on a mesh yet)
BUILDS = ("h2o-danube-1.8b", "jamba-v0.1-52b", "qwen2-7b", "olmoe-1b-7b",
          "granite-moe-1b-a400m", "phi3-mini-3.8b", "llama3-405b",
          "xlstm-1.3b", "seamless-m4t-medium", "pixtral-12b")
REL = 1e-5


class FakeMesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **over):
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)), **over)
    jcfg = dataclasses.replace(jreg.reduce_config(jreg.get_config(arch)),
                               **over)
    return cfg, jcfg


def _ref_tree(tree):
    """The reference's spec tree as plain tuples (dicts and tuples kept)."""
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda x: isinstance(x, P))


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, sh.Spec):
        return tuple(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(_port_tree(v) for v in tree)
    return tree


@pytest.mark.parametrize("arch", BUILDS)
def test_param_specs_are_the_reference_specs(arch):
    cfg, jcfg = _cfgs(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    for kw in ({}, {"fsdp_axis": "data"}):
        assert _port_tree(sh.param_specs(params, **kw)) == _ref_tree(
            jsh.param_specs(shapes, **kw)), kw
    # sanitized against the leaves' shapes on two meshes
    specs = sh.param_specs(params)
    jspecs = jsh.param_specs(shapes)
    for data, model in ((2, 4), (4, 4)):
        mesh = FakeMesh(data, model)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = _port_tree(sh.named_shardings(mesh, specs, params))
            want = _ref_tree(jax.tree_util.tree_map(
                lambda s, l: jsh.sanitize_spec(mesh, s, l.shape), jspecs,
                shapes, is_leaf=lambda x: isinstance(x, P)))
        assert got == want, (data, model)


@pytest.mark.parametrize("arch", BUILDS)
def test_cache_and_batch_specs_are_the_reference_specs(arch):
    cfg, jcfg = _cfgs(arch)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 16))
    for kw in (dict(batch_axes=("data",), model_axis="model", model_size=4),
               dict(batch_axes=(), model_axis="model", model_size=2,
                    seq_axis="data"),
               dict(batch_axes=("data",), model_axis="model",
                    model_size=cfg.num_kv_heads)):
        got = sh.cache_specs(cache, num_kv_heads=cfg.num_kv_heads, **kw)
        want = jsh.cache_specs(jcache, num_kv_heads=jcfg.num_kv_heads, **kw)
        assert _port_tree(got) == _ref_tree(want), kw
    batch = {"tokens": np.zeros((4, 8), np.int32), "pos": np.int32(0)}
    for axes in (("data",), ()):
        assert _port_tree(sh.batch_specs(batch, axes)) == _ref_tree(
            jsh.batch_specs(batch, axes))


class TestSanitizeSpec:
    MESH = FakeMesh(4, 16)

    @pytest.fixture(autouse=True)
    def _fresh_warnings(self):
        saved = set(sh._SANITIZE_WARNED)
        sh._SANITIZE_WARNED.clear()
        yield
        sh._SANITIZE_WARNED.clear()
        sh._SANITIZE_WARNED.update(saved)

    @pytest.mark.parametrize("spec,shape", [
        (("model", None), (256206, 64)), (("model", None), (256, 64)),
        ((None, "model"), (64,)), ((("model", "data"), None), (128, 8)),
        ((("model", "data"), None), (96, 8)), (("data",), (99,))])
    def test_is_the_reference_rule(self, spec, shape):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = sh.sanitize_spec(self.MESH, sh.Spec(*spec), shape)
            want = jsh.sanitize_spec(self.MESH, P(*spec), shape)
        assert tuple(got) == tuple(want)

    def test_warns_once_per_distinct_drop(self):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(3):
                sh.sanitize_spec(self.MESH, sh.Spec("model", None),
                                 (256206, 64))
            sh.sanitize_spec(self.MESH, sh.Spec("data"), (99,))
            sh.sanitize_spec(self.MESH, sh.Spec(None, "model"), (64,))
        msgs = [str(c.message) for c in caught
                if issubclass(c.category, UserWarning)]
        assert len(msgs) == 3, msgs
        assert "dim 0 of size 256206" in msgs[0]
        assert "do not divide" in msgs[1]
        assert "beyond the leaf's rank" in msgs[2]


class TestExperimentMesh:
    CPU2 = [torch.device("cpu")] * 2

    def test_rejects_bad_count(self):
        with pytest.raises(ValueError, match=">= 1"):
            sh.experiment_mesh(0)

    def test_one_device_is_none_or_the_reference_message(self):
        assert sh.experiment_mesh(4, devices=["cpu"]) is None
        with pytest.raises(ValueError, match="force host devices"):
            sh.experiment_mesh(4, devices=["cpu"], require=True)
        if torch.cuda.device_count() <= 1:
            assert sh.experiment_mesh(4) is None

    def test_nondividing_grid_is_none_or_the_reference_message(self):
        devs = ["cpu"] * 4
        assert sh.experiment_mesh(6, devices=devs) is None
        with pytest.raises(ValueError, match="pad the grid"):
            sh.experiment_mesh(6, devices=devs, require=True)

    def test_mesh_and_shard_experiment_axis(self):
        mesh = sh.experiment_mesh(4, devices=self.CPU2, require=True)
        assert mesh.devices == (torch.device("cpu"),) * 2
        assert mesh.axis_name == sh.EXPERIMENT_AXIS == "exp"
        tree = {"w": torch.arange(8.0).reshape(4, 2), "s": torch.tensor(3.0),
                "o": (torch.arange(4),)}
        parts = sh.shard_experiment_axis(tree, mesh)
        assert [p["w"].tolist() for p in parts] == [[[0, 1], [2, 3]],
                                                    [[4, 5], [6, 7]]]
        assert [p["o"][0].tolist() for p in parts] == [[0, 1], [2, 3]]
        assert all(float(p["s"]) == 3.0 for p in parts)


# ---------------------------------------------------------------------------
# the cut


def _leaves(tree):
    return pytree.tree_leaves(tree)


@pytest.mark.parametrize("arch,data,model", [
    ("jamba-v0.1-52b", 1, 2), ("jamba-v0.1-52b", 2, 2),
    ("jamba-v0.1-52b", 1, 4), ("qwen2-7b", 1, 4), ("olmoe-1b-7b", 2, 2),
    ("xlstm-1.3b", 1, 2), ("seamless-m4t-medium", 1, 2)])
def test_init_sharded_params_is_the_shard_of_init_params(arch, data, model):
    cfg, _ = _cfgs(arch)
    mesh = make_host_mesh(data, model)
    full = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    shards = []
    for r in range(mesh.size):
        want = sh.shard_params(full, mesh, r, cfg)
        got = T.init_sharded_params(cfg, torch.Generator().manual_seed(3),
                                    mesh, r, device="cpu")
        assert pytree.tree_structure(got) == pytree.tree_structure(want)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                     _leaves(want)))
        shards.append(got)
    back = sh.gather_params(shards, mesh, cfg, full)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back),
                                                 _leaves(full)))


def test_plan_and_rank_shapes():
    cfg, _ = _cfgs("jamba-v0.1-52b")
    plan = sh.tp_plan(cfg, 4)
    assert plan == sh.TPPlan(model=4, heads=True, kv=False, mlp=True,
                             experts=True, mamba=True, vocab=True)
    full = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = sh.shard_params(full, make_host_mesh(1, 4), 1, cfg)
    attn, mamba = p["blocks"][0]["attn"], p["blocks"][1]["mamba"]
    hd, di = cfg.head_dim, cfg.mamba_d_inner
    assert attn["wq"].shape[-1] == hd            # one q head a rank
    assert attn["wk"].shape[-1] == cfg.num_kv_heads * hd     # kv whole
    assert mamba["in_proj"].shape[-1] == 2 * di // 4
    assert p["blocks"][1]["moe"]["w_gate"].shape[1] == cfg.num_experts // 4
    assert p["emb"]["tok"].shape[0] == cfg.vocab_size // 4
    # the real config over four ranks cuts every module
    assert all(sh.tp_plan(reg.get_config("jamba-v0.1-52b"), 4))


def test_in_proj_shard_is_a_slice_of_each_half():
    """Rank m's ``in_proj`` is [u_m | z_m]: columns m of the first d_inner
    and of the second, not a contiguous run of the 2 d_inner columns."""
    cfg, _ = _cfgs("jamba-v0.1-52b")
    full = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = full["blocks"][1]["mamba"]["in_proj"]
    di, model = cfg.mamba_d_inner, 4
    per = di // model
    mesh = make_host_mesh(1, model)
    for m in range(model):
        got = sh.shard_params(full, mesh, m, cfg)["blocks"][1]["mamba"][
            "in_proj"]
        want = torch.cat([w[..., m * per:(m + 1) * per],
                          w[..., di + m * per:di + (m + 1) * per]], dim=-1)
        assert torch.equal(got, want), m


def _layer_on_mesh(fn, mesh):
    """``fn(ctx)`` on every rank of an emulated mesh, under inference
    mode."""
    with torch.inference_mode():
        return run_ranks(mesh, fn)


def _close(got, want, rel=REL):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("model", [2, 4])
def test_mamba_mixer_on_its_channel_shards(model):
    """The mixer on each rank's channels (the conv, K7's plain version, the
    gate; x_proj's and out_proj's partials folded) against the whole
    mixer: the output and each rank's slice of the final state."""
    cfg, _ = _cfgs("jamba-v0.1-52b", dtype="float32")
    full = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    mesh = make_host_mesh(1, model)
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    one = {k: v[0] for k, v in full["blocks"][1]["mamba"].items()}
    with torch.inference_mode():
        want, (h, tail) = M.mamba_mix(one, cfg, x, return_state=True)
    shards = [sh.shard_params(full, mesh, r, cfg) for r in range(mesh.size)]
    outs = _layer_on_mesh(lambda ctx: M.mamba_mix(
        {k: v[0] for k, v in shards[ctx.rank]["blocks"][1]["mamba"].items()},
        cfg, x, return_state=True, tp=ctx), mesh)
    per = cfg.mamba_d_inner // model
    for r, (out, (hr, tr)) in enumerate(outs):
        _close(out, want)
        _close(hr, h[:, r * per:(r + 1) * per])
        _close(tr, tail[..., r * per:(r + 1) * per])


@pytest.mark.parametrize("arch,model", [("qwen2-7b", 4), ("qwen2-7b", 2),
                                        ("jamba-v0.1-52b", 4)])
def test_attention_on_its_head_shards(arch, model):
    """The attention layer on each rank's heads against the whole layer.
    Reduced qwen2 at four ranks has 2 kv heads: the kv projections stay
    whole on every rank (their 128 columns divide by 4, but a contiguous
    cut would split a head) and each rank reads its q head's kv head."""
    cfg, _ = _cfgs(arch, dtype="float32")
    full = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    mesh = make_host_mesh(1, model)
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    one = {k: v[0] for k, v in full["blocks"][0]["attn"].items()}
    if "bk" in one:             # nonzero biases, so a wrong cut shows
        g = torch.Generator().manual_seed(5)
        full = dict(full, blocks=(dict(full["blocks"][0], attn=dict(
            full["blocks"][0]["attn"], **{n: torch.randn(
                full["blocks"][0]["attn"][n].shape, generator=g)
                for n in ("bq", "bk", "bv")})),) + full["blocks"][1:])
        one = {k: v[0] for k, v in full["blocks"][0]["attn"].items()}
    with torch.inference_mode():
        want, (k, v) = L.attention(one, cfg, x, return_kv=True,
                                   window=cfg.sliding_window)
    plan = sh.tp_plan(cfg, model)
    shards = [sh.shard_params(full, mesh, r, cfg) for r in range(mesh.size)]
    outs = _layer_on_mesh(lambda ctx: L.attention(
        {n: t[0] for n, t in shards[ctx.rank]["blocks"][0]["attn"].items()},
        cfg, x, return_kv=True, window=cfg.sliding_window, tp=ctx), mesh)
    hkv = cfg.num_kv_heads // model
    for r, (out, (kr, vr)) in enumerate(outs):
        _close(out, want)
        if plan.kv:
            _close(kr, k[:, :, r * hkv:(r + 1) * hkv])
        else:
            _close(kr, k)
            _close(vr, v)


def test_mesh_helpers_are_the_reference_helpers():
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as lmesh
    for data, model in ((1, 1), (2, 4), (4, 2)):
        m = make_host_mesh(data, model)
        assert not m.physical and m.size == data * model
        assert list(m.local_ranks) == list(range(data * model))
        assert [m.coords(r) for r in range(m.size)] == [
            (r // model, r % model) for r in range(m.size)]
        for fn in ("mesh_axes", "dp_axes", "num_fl_devices"):
            assert getattr(lmesh, fn)(m) == getattr(jmesh, fn)(m), fn
    assert make_host_mesh(2, 2, emulate=True).rank is None
    with pytest.raises(ValueError, match=">= 1"):
        make_host_mesh(0, 2)
