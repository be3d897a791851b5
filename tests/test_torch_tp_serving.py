"""The port's serving mesh against the JAX package's unsharded serving, on
the CPU, with the reference's weights (``interop.model_params_from_jax``)
and token ids drawn with numpy:

* reduced jamba-v0.1-52b (fp32) on an emulated ``(1, 2)`` and ``(2, 2)``
  mesh: the last position's logits within ``1e-5 max|logits|`` of the
  reference's ``forward_hidden`` (the rank's partials folded in another
  order than one product's sum), and the prefill's token and 8 greedy
  decode tokens equal to its ``prefill_with_cache`` / ``decode_step``;
* context-parallel decode over ``(4, 2)`` (``tests/test_distribution.py::
  test_context_parallel_decode_matches_single_device``): 8 teacher-forced
  steps from an empty cache, tokens equal;
* the sequence-cut cache (``shard_cache_seq``) on reduced qwen2 and on
  the reference's own case, reduced pixtral, over ``(2, 4)``, 2 kv heads
  under 4 model ranks (``::test_seq_sharded_decode_matches_reference``):
  tokens equal;
* pixtral's vision prefix on a ``(2, 2)`` mesh (``modal_proj`` whole on
  every rank, the image embeddings cut with the batch over ``data``): the
  prefill's token and 8 greedy decode tokens equal to the reference's;
* in one subprocess of four ``gloo`` ranks (the physical mesh: a rank a
  process, the shards gathered over the process groups): the three meshes
  above, every rank's ids and cache bitwise the emulated mesh's.

torch runs on one thread in this file and in the ranks.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import registry as reg
from repro_torch.distribution.tensor_parallel import run_ranks
from repro_torch.distribution import sharding as sh
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
REL = 1e-5
_J_FORWARD = jax.jit(JT.forward_hidden, static_argnums=(1,))
_J_PREFILL = jax.jit(JT.prefill_with_cache, static_argnums=(1, 3))
_J_DECODE = jax.jit(JT.decode_step, static_argnums=(1,))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model(arch, **over):
    """(reference cfg, port cfg, reference params, port params), fp32."""
    over = dict(dtype="float32", **over)
    jcfg = dataclasses.replace(jreg.reduce_config(jreg.get_config(arch)),
                               **over)
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)), **over)
    jp = JT.init_params(jcfg, KEY)
    p = interop.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, p


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _ref_greedy(jcfg, jp, toks, cache_len, steps):
    """The reference's prefill token and ``steps`` greedy decode tokens."""
    s = toks.shape[1]
    h, cache = _J_PREFILL(jp, jcfg, {"tokens": jnp.asarray(toks)}, cache_len)
    ids = jnp.argmax((h[:, -1] @ JL.unembed_matrix(jp["emb"], jcfg))
                     .astype(jnp.float32), axis=-1).astype(jnp.int32)
    out = [np.asarray(ids)]
    for pos in range(s, s + steps):
        logits, cache = _J_DECODE(jp, jcfg, cache, ids[:, None],
                                  jnp.asarray(pos))
        ids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(ids))
    return np.stack(out, axis=1)


def _ref_forced(jcfg, jp, toks, maxlen):
    """The reference's plain decode from an empty cache, teacher-forced."""
    cache = JT.init_cache(jcfg, toks.shape[0], maxlen)
    out = []
    for pos in range(toks.shape[1]):
        logits, cache = _J_DECODE(jp, jcfg, cache,
                                  jnp.asarray(toks[:, pos:pos + 1]),
                                  jnp.asarray(pos))
        out.append(np.asarray(jnp.argmax(logits, axis=-1)))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_hybrid_tensor_parallel_prefill_and_decode(data, model):
    jcfg, cfg, jp, p = _model("jamba-v0.1-52b")
    mesh = make_host_mesh(data, model)
    assert not mesh.physical and all(sh.tp_plan(cfg, model))
    toks = _tokens(cfg, 4, 16)
    h = _J_FORWARD(jp, jcfg, {"tokens": jnp.asarray(toks)})
    want = np.asarray((h[:, -1] @ JL.unembed_matrix(jp["emb"], jcfg))
                      .astype(jnp.float32))
    shards = [sh.shard_params(p, mesh, r, cfg) for r in range(mesh.size)]
    per = 4 // data

    def program(ctx):
        ctx.batch_split = data > 1
        rows = torch.from_numpy(toks[ctx.d * per:(ctx.d + 1) * per])
        x = T.forward_hidden(shards[ctx.rank], cfg, {"tokens": rows},
                             tp=ctx)
        return L.logits(shards[ctx.rank]["emb"], cfg, x[:, -1], ctx)
    with torch.inference_mode():
        logits = run_ranks(mesh, program)
    scale = float(np.abs(want).max())
    for r, got in enumerate(logits):
        d = r // model
        err = float(np.abs(got.numpy() - want[d * per:(d + 1) * per]).max())
        assert err <= REL * scale, (r, err, scale)

    prefill, place = serve.build_prefill_cache_step(cfg, "cpu",
                                                    cache_len=24, mesh=mesh)
    decode, _ = serve.build_decode_step(cfg, "cpu", mesh=mesh)
    params, _ = place(p)
    ids, cache = prefill(params, {"tokens": torch.from_numpy(toks)})
    got = [ids]
    for pos in range(16, 24):
        ids, cache = decode(params, cache, ids[:, None], pos)
        got.append(ids)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  _ref_greedy(jcfg, jp, toks, 24, 8))


def test_context_parallel_decode_matches_single_device():
    jcfg, cfg, jp, p = _model("jamba-v0.1-52b")
    toks = _tokens(cfg, 2, 8, seed=2)
    mesh = make_host_mesh(4, 2)
    step, place = serve.build_decode_step(cfg, "cpu", mesh=mesh,
                                          context_parallel=True, cache_len=32)
    params, cache = place(p, T.init_cache(cfg, 2, 32, cp_shards=4,
                                          device="cpu"))
    assert cache[0][0]["k"].shape[2] == 32 // 4
    got = []
    for pos in range(8):
        ids, cache = step(params, cache,
                          torch.from_numpy(toks[:, pos:pos + 1]), pos)
        got.append(ids)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  _ref_forced(jcfg, jp, toks, 32))
    with pytest.raises(ValueError, match="divide"):
        T.init_cache(cfg, 2, 30, cp_shards=4, device="cpu")


def test_seq_sharded_decode_matches_reference():
    jcfg, cfg, jp, p = _model("qwen2-7b", decode_cache_update="select")
    toks = _tokens(cfg, 2, 8, seed=3)
    mesh = make_host_mesh(2, 4)           # model 4 > kv 2: the seq is cut
    step, place = serve.build_decode_step(cfg, "cpu", mesh=mesh,
                                          shard_cache_seq=True)
    params, cache = place(p, T.init_cache(cfg, 2, 16, device="cpu"))
    assert cache[0][0]["k"].shape[1:4] == (1, 16 // 4, cfg.num_kv_heads)
    got = []
    for pos in range(8):
        ids, cache = step(params, cache,
                          torch.from_numpy(toks[:, pos:pos + 1]), pos)
        got.append(ids)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  _ref_forced(jcfg, jp, toks, 16))


def test_seq_sharded_decode_matches_reference_pixtral():
    """The reference's own case: reduced pixtral, select update, the cache's
    sequence cut over model = 4 > kv = 2."""
    jcfg, cfg, jp, p = _model("pixtral-12b", decode_cache_update="select")
    toks = _tokens(cfg, 2, 8, seed=1)
    step, place = serve.build_decode_step(cfg, "cpu",
                                          mesh=make_host_mesh(2, 4),
                                          shard_cache_seq=True)
    params, cache = place(p, T.init_cache(cfg, 2, 16, device="cpu"))
    assert cache[0][0]["k"].shape[1:4] == (1, 16 // 4, cfg.num_kv_heads)
    got = []
    for pos in range(8):
        ids, cache = step(params, cache,
                          torch.from_numpy(toks[:, pos:pos + 1]), pos)
        got.append(ids)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  _ref_forced(jcfg, jp, toks, 16))


def test_vision_prefix_on_a_mesh():
    jcfg, cfg, jp, p = _model("pixtral-12b")
    toks = _tokens(cfg, 4, 8, seed=4)
    img = np.random.default_rng(5).standard_normal(
        (4, cfg.num_modal_tokens, cfg.modal_embed_dim)).astype(np.float32)
    s = cfg.num_modal_tokens + 8
    mesh = make_host_mesh(2, 2)
    prefill, place = serve.build_prefill_cache_step(cfg, "cpu",
                                                    cache_len=s + 8,
                                                    mesh=mesh)
    decode, _ = serve.build_decode_step(cfg, "cpu", mesh=mesh)
    params, _ = place(p)
    assert all(torch.equal(r["emb"]["modal_proj"], p["emb"]["modal_proj"])
               for r in params)
    ids, cache = prefill(params, {"tokens": torch.from_numpy(toks),
                                  "modal_embeds": torch.from_numpy(img)})
    got = [ids]
    for pos in range(s, s + 8):
        ids, cache = decode(params, cache, ids[:, None], pos)
        got.append(ids)
    jh, jc = _J_PREFILL(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "modal_embeds": jnp.asarray(img)}, s + 8)
    jids = jnp.argmax((jh[:, -1] @ JL.unembed_matrix(jp["emb"], jcfg))
                      .astype(jnp.float32), axis=-1).astype(jnp.int32)
    want = [np.asarray(jids)]
    for pos in range(s, s + 8):
        logits, jc = _J_DECODE(jp, jcfg, jc, jids[:, None], jnp.asarray(pos))
        jids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(jids))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  np.stack(want, 1))


def test_builders_without_a_mesh_refuse_the_sharded_options():
    _, cfg, _, _ = _model("qwen2-7b")
    for kw in (dict(context_parallel=True), dict(shard_cache_seq=True)):
        with pytest.raises(ValueError, match="mesh="):
            serve.build_decode_step(cfg, "cpu", **kw)


# ---------------------------------------------------------------------------
# the physical mesh: four gloo ranks


RANKS_SCRIPT = r'''
import dataclasses
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANKS = 4


def cases():
    """(name, data, model, arch, config changes, decode options)."""
    return [("tp_2x2", 2, 2, "jamba-v0.1-52b", {}, {}),
            ("cp_4x1", 4, 1, "jamba-v0.1-52b", {},
             dict(context_parallel=True, cache_len=16)),
            ("seq_1x4", 1, 4, "qwen2-7b", dict(decode_cache_update="select"),
             dict(shard_cache_seq=True))]


def run_case(mesh, arch, over, opts):
    from repro_torch.configs import registry as reg
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                              dtype="float32", **over)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 8)))
    step, place = serve.build_decode_step(cfg, "cpu", mesh=mesh, **opts)
    if opts.get("context_parallel") or opts.get("shard_cache_seq"):
        params, cache = place(p, T.init_cache(cfg, 4, 16, device="cpu"))
        ids, out = None, []
        for pos in range(4):
            ids, cache = step(params, cache, toks[:, pos:pos + 1], pos)
            out.append(ids)
    else:
        prefill, place_p = serve.build_prefill_cache_step(
            cfg, "cpu", cache_len=16, mesh=mesh)
        params, _ = place_p(p)
        ids, cache = prefill(params, {"tokens": toks})
        out = [ids]
        for pos in range(8, 12):
            ids, cache = step(params, cache, ids[:, None], pos)
            out.append(ids)
    return {"ids": torch.stack(out, 1), "cache": cache}


def worker(rank, port, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(os.environ["ROOT"], "tests"))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for name, data, model, arch, over, opts in cases():
        mesh = make_host_mesh(data, model)
        assert mesh.physical and mesh.rank == rank
        res[name] = run_case(mesh, arch, over, opts)
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
def physical(tmp_path_factory):
    """Every rank's results and the script's cases, from one subprocess
    that spawns four ``gloo`` ranks on 127.0.0.1."""
    tmp = tmp_path_factory.mktemp("serve_ranks")
    script = tmp / "ranks.py"
    script.write_text(textwrap.dedent(RANKS_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), ROOT=ROOT,
               MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(tmp)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0 and "RANKS_OK" in r.stdout, r.stderr[-4000:]
    namespace = {}
    exec(compile(RANKS_SCRIPT.split("def worker")[0], "ranks", "exec"),
         namespace)
    return ([torch.load(tmp / f"rank{i}.pt", weights_only=False)
             for i in range(4)], namespace)


def _leaves(tree):
    import torch.utils._pytree as pytree
    return pytree.tree_leaves(tree)


@pytest.mark.parametrize("case", ["tp_2x2", "cp_4x1", "seq_1x4"])
def test_physical_ranks_are_the_emulated_mesh_bitwise(physical, case):
    ranks, ns = physical
    name, data, model, arch, over, opts = next(c for c in ns["cases"]()
                                               if c[0] == case)
    want = ns["run_case"](make_host_mesh(data, model), arch, over, opts)
    for r, res in enumerate(ranks):
        got = res[case]
        assert torch.equal(got["ids"], want["ids"]), r
        mine, theirs = _leaves(got["cache"]), _leaves(want["cache"][r])
        assert len(mine) == len(theirs)
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs)), r
