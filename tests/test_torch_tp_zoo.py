"""xlstm-1.3b and seamless-m4t-medium on the ``(data, model)`` mesh, on the
CPU, reduced and at fp32:

* serving cut over ``(1, 2)`` (seamless also ``(1, 4)``, and both over
  ``(2, 2)``) against the uncut model: the last position's logits within
  ``REL`` of the uncut ones, the prefill's token and 8 greedy decode
  tokens equal (the mLSTM on the rank's heads, the sLSTM's whole
  recurrence on every rank, the encoder cut as the decoder);
* the prefill -> decode cache handoff on the mesh: teacher-forced decode
  steps after a mesh prefill against the uncut model's, logits within
  ``REL``; the mesh's cache is the rank's cut of the uncut cache;
* the reference's GSPMD prefill (``jax.jit`` over its ``param_specs`` on a
  ``(1, 2)`` forced-host mesh, one subprocess) against the port's (1, 2)
  prefill, the reference's weights carried across: logits within ``REL``;
* training over ``(2, 2)``: each rank's gradient gathered against the
  uncut model's (``tests/test_torch_tp_train.py``'s rule; the encoder's
  leaves, which the loss does not read, exactly zero), the replicated
  leaves the same bits on every model rank, and ``enter`` without its
  backward fold rejected.

The physical mesh (four ``gloo`` ranks) is held bitwise to the emulated
one in ``tests/test_torch_tp_train.py``, which spawns its ranks once.
torch runs on one thread in this file.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.distribution import sharding as SH
from repro_torch.distribution import tensor_parallel as TPM
from repro_torch.distribution.tensor_parallel import run_ranks
from repro_torch.launch import serve
from repro_torch.launch import train as tl
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLSTM, SEAMLESS = "xlstm-1.3b", "seamless-m4t-medium"
# fp32: cut logits within REL of the uncut (or the reference's) largest
# logit (measured at most 1.4e-6: the row-parallel products and the folds
# sum in other orders)
REL = 1e-5
# a cut gradient leaf within GRAD_REL of the uncut leaf's largest entry
# (tests/test_torch_tp_train.py's bound; measured 1.8e-6, xlstm)
GRAD_REL = 2e-5
PROMPT, DECODE, FRAMES = 32, 8, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch):
    return dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                               dtype="float32")


def _params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


def _batch(cfg, b=4, s=PROMPT, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s)))}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, FRAMES, cfg.modal_embed_dim)).astype(np.float32))
    return batch


def _greedy(cfg, params, batch, mesh=None):
    """The prefill's token and DECODE greedy tokens through the serve
    builders (on ``mesh`` with the encoder's output from
    ``build_encode_step``)."""
    s = batch["tokens"].shape[1]
    kw = {} if mesh is None else {"mesh": mesh}
    pre = serve.build_prefill_cache_step(cfg, "cpu", cache_len=s + DECODE,
                                         **kw)
    dec = serve.build_decode_step(cfg, "cpu", **kw)
    enc = serve.build_encode_step(cfg, "cpu", **kw)
    if mesh is not None:
        (pre, place), (dec, _), (enc, _) = pre, dec, enc
        params = place(params)[0]
    enc_out = enc(params, batch) if cfg.is_encoder_decoder else None
    ids, cache = pre(params, batch)
    out = [ids]
    for pos in range(s, s + DECODE):
        ids, cache = dec(params, cache, ids[:, None], pos, enc_out=enc_out)
        out.append(ids)
    return torch.stack(out, 1)


def _last_logits(cfg, params, batch, mesh):
    """Every rank's last-position logits of its rows."""
    shards = [SH.shard_params(params, mesh, r, cfg)
              for r in range(mesh.size)]
    per = batch["tokens"].shape[0] // mesh.data

    def program(ctx):
        ctx.batch_split = mesh.data > 1
        rows = {k: v[ctx.d * per:(ctx.d + 1) * per]
                for k, v in batch.items()}
        x = T.forward_hidden(shards[ctx.rank], cfg, rows, tp=ctx)
        return L.logits(shards[ctx.rank]["emb"], cfg, x[:, -1], ctx)
    with torch.inference_mode():
        return run_ranks(mesh, program)


def _logit_gap(mesh, got, want) -> float:
    per = want.shape[0] // mesh.data
    return max(float((g - want[(r // mesh.model) * per:
                               (r // mesh.model + 1) * per]).abs().max())
               for r, g in enumerate(got)) / float(want.abs().max())


SERVE_CASES = {"xlstm_1x2": (XLSTM, (1, 2)), "xlstm_2x2": (XLSTM, (2, 2)),
               "seamless_1x2": (SEAMLESS, (1, 2)),
               "seamless_1x4": (SEAMLESS, (1, 4)),
               "seamless_2x2": (SEAMLESS, (2, 2))}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_cut_serving_matches_uncut(case):
    arch, shape = SERVE_CASES[case]
    cfg = _cfg(arch)
    mesh = make_host_mesh(*shape)
    plan = SH.tp_plan(cfg, mesh.model)
    assert plan.heads and plan.vocab and (plan.mlp or cfg.is_xlstm)
    params = _params(cfg)
    batch = _batch(cfg)
    with torch.inference_mode():
        h = T.forward_hidden(params, cfg, batch)
        want = (h[:, -1] @ L.unembed_matrix(params["emb"], cfg)).float()
    gap = _logit_gap(mesh, _last_logits(cfg, params, batch, mesh), want)
    assert gap <= REL, gap
    assert torch.equal(_greedy(cfg, params, batch, mesh),
                       _greedy(cfg, params, batch))


@pytest.mark.parametrize("arch", [XLSTM, SEAMLESS])
def test_prefill_decode_handoff_on_the_mesh(arch):
    """A (2, 2) mesh prefill over PROMPT tokens, then 4 teacher-forced
    decode steps: the logits against the uncut model's same steps, and
    the mesh's cache (gathered) against the uncut prefill's cache."""
    cfg = _cfg(arch)
    params = _params(cfg, seed=2)
    mesh = make_host_mesh(2, 2)
    full = _batch(cfg, s=PROMPT + 4, seed=3)
    batch = dict(full, tokens=full["tokens"][:, :PROMPT])
    cache_len = PROMPT + 4
    with torch.inference_mode():
        enc = T.encode_for_decode(params, cfg, batch)
        _, cache = T.prefill_with_cache(params, cfg, batch, cache_len)
        want_cache = {k: v.clone()
                      for k, v in tree_flatten(list(cache)).items()}
        want = []
        for pos in range(PROMPT, PROMPT + 4):
            lg, cache = T.decode_step(params, cfg, cache,
                                      full["tokens"][:, pos:pos + 1], pos,
                                      enc_out=enc)
            want.append(lg)
    shards = [SH.shard_params(params, mesh, r, cfg) for r in range(mesh.size)]

    def program(ctx):
        ctx.batch_split = True
        rows = {k: v[ctx.d * 2:(ctx.d + 1) * 2] for k, v in batch.items()}
        p = shards[ctx.rank]
        e = T.encode_for_decode(p, cfg, rows, tp=ctx)
        _, c = T.prefill_with_cache(p, cfg, rows, cache_len, tp=ctx)
        first = [t.clone() for t in tree_leaves(list(c))]
        out = []
        for pos in range(PROMPT, PROMPT + 4):
            lg, c = T.decode_step(p, cfg, c, full["tokens"][
                ctx.d * 2:(ctx.d + 1) * 2, pos:pos + 1], pos, enc_out=e,
                tp=ctx)
            out.append(lg)
        return out, first
    with torch.inference_mode():
        outs = run_ranks(mesh, program)
    scale = max(float(w.abs().max()) for w in want)
    for r, (got, _) in enumerate(outs):
        d = r // mesh.model
        for g, w in zip(got, want):
            assert float((g - w[d * 2:(d + 1) * 2]).abs().max()) \
                <= REL * scale
    like = T.init_cache(cfg, 4, cache_len, device="cpu")
    specs = serve._decode_cache_specs(cfg, mesh, like)
    whole = SH.gather_cache([tree_unflatten(list(like), {
        f"{i:05d}": t for i, t in enumerate(first)}) for _, first in outs],
        mesh, specs)
    for k, w in want_cache.items():
        g = tree_flatten(list(whole))[k]
        assert float((g - w).abs().max()) <= REL * max(
            float(w.abs().max()), 1.0), k


# ---------------------------------------------------------------------------
# the reference's GSPMD prefill on a (1, 2) forced-host mesh


REFERENCE_SCRIPT = r'''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax
import numpy as np
from repro.configs.registry import get_config, reduce_config
from repro.distribution import sharding as sh
from repro.launch.mesh import make_host_mesh
from repro.models import layers as L
from repro.models import transformer as T

ARCHS, PROMPT, FRAMES = eval(sys.argv[2])
mesh = make_host_mesh(1, 2)
res = {}
for arch in ARCHS:
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32")
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (2, PROMPT)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.standard_normal(
            (2, FRAMES, cfg.modal_embed_dim)).astype(np.float32)

    def logits(p, b):
        x = T.forward_hidden(p, cfg, b)
        return (x[:, -1] @ L.unembed_matrix(p["emb"], cfg)).astype(
            np.float32)
    ps = sh.named_shardings(mesh, sh.param_specs(params, model_axis="model"),
                            params)
    bs = sh.named_shardings(mesh, sh.batch_specs(batch, ("data",)), batch)
    with jax.set_mesh(mesh):
        out = jax.jit(logits, in_shardings=(ps, bs))(
            jax.device_put(params, ps), jax.device_put(batch, bs))
    for k, v in batch.items():
        res[f"{arch}/{k}"] = v
    res[f"{arch}/logits"] = np.asarray(out)
    for i, l in enumerate(jax.tree_util.tree_leaves(params)):
        res[f"{arch}/p/{i:05d}"] = np.asarray(l)
np.savez(sys.argv[1], **res)
print("REF_TP_ZOO_OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_tp_zoo")
    script = tmp / "ref_tp_zoo.py"
    script.write_text(REFERENCE_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), str(tmp / "ref.npz"),
                        repr(((XLSTM, SEAMLESS), PROMPT, FRAMES))],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert "REF_TP_ZOO_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("arch", [XLSTM, SEAMLESS])
def test_gspmd_prefill_matches_reference(reference, arch):
    cfg = _cfg(arch)
    like = T.init_params(cfg, torch.Generator(), device="cpu")
    n = len(tree_leaves(like))
    params = tree_unflatten(like, {f"{i:05d}": torch.from_numpy(
        reference[f"{arch}/p/{i:05d}"]) for i in range(n)})
    batch = {k: torch.from_numpy(reference[f"{arch}/{k}"])
             for k in ("tokens", "src_embeds") if f"{arch}/{k}" in reference}
    mesh = make_host_mesh(1, 2)
    want = torch.from_numpy(reference[f"{arch}/logits"])
    gap = _logit_gap(mesh, _last_logits(cfg, params, batch, mesh), want)
    assert gap <= REL, gap


# ---------------------------------------------------------------------------
# training over (2, 2)


def _rank_grads(cfg, params, batch, mesh):
    def program(ctx):
        p = SH.shard_params(params, mesh, ctx.rank, cfg)
        _, _, g = tl._client_grads(cfg, ctx, p, batch)
        return tree_unflatten(p, tree_flatten(g))
    return run_ranks(mesh, program)


def _grad_gaps(cfg, params, batch, mesh, outs):
    """The largest relative gap of a gathered gradient leaf to the uncut
    model's (a leaf the loss does not read: exactly zero), and whether
    every replicated leaf is the same bits on every model rank."""
    want = tl._value_and_grad(lambda q: T.forward_loss(q, cfg, batch),
                              params)[2]
    full = SH.gather_params(outs, mesh, cfg, params)
    gap = 0.0
    for a, b in zip(tree_leaves(full), want):
        scale = float(b.abs().max())
        gap = max(gap, float((a - b).abs().max()) / scale if scale > 0
                  else float("inf") if a.abs().max() > 0 else 0.0)
    lay = SH.CutLayout(outs[0], cfg, mesh, 0)
    flat = [tree_flatten(o) for o in outs]
    same = all(torch.equal(f[k], flat[0][k]) for f in flat[1:]
               for k in flat[0] if not lay.cut[k])
    return gap, same


def _train_batch(cfg):
    batch = _batch(cfg, b=2, seed=5)
    toks = batch["tokens"]
    batch.update(labels=toks.roll(-1, 1),
                 loss_mask=(torch.rand(toks.shape, generator=torch
                                       .Generator().manual_seed(6)) > 0.2)
                 .float())
    return batch


@pytest.mark.parametrize("arch", [XLSTM, SEAMLESS])
def test_cut_gradients_match_uncut(arch):
    cfg = _cfg(arch)
    params = _params(cfg)
    batch = _train_batch(cfg)
    mesh = make_host_mesh(2, 2)
    gap, same = _grad_gaps(cfg, params, batch, mesh,
                           _rank_grads(cfg, params, batch, mesh))
    assert gap <= GRAD_REL, gap
    assert same


@pytest.mark.parametrize("arch", [XLSTM, SEAMLESS])
def test_missing_enter_is_rejected(arch, monkeypatch):
    cfg = _cfg(arch)
    params = _params(cfg)
    batch = _train_batch(cfg)
    mesh = make_host_mesh(2, 2)
    monkeypatch.setattr(TPM.RankContext, "enter",
                        lambda self, x, axis="model": x)
    outs = _rank_grads(cfg, params, batch, mesh)
    monkeypatch.undo()
    gap, same = _grad_gaps(cfg, params, batch, mesh, outs)
    assert gap > 1e3 * GRAD_REL, gap
