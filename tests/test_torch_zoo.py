"""The last three zoo configs' serving path against the JAX package, on the
CPU: xlstm-1.3b (the mLSTM and sLSTM cells), seamless-m4t-medium (the
encoder, and the ``xattn`` cross-attention block that no config uses) and
pixtral-12b (the vision prefix), each ``reduce_config`` at fp32.

Params come from the reference's ``init_params`` / ``init_block`` and are
carried across with ``interop.model_params_from_jax``; token ids and the
stub frontends' embeddings are drawn with numpy.  Tolerance ``1e-5 *
max|reference|`` for every compared tensor (fp32 sums in other orders:
the port's pairwise einsums and batched products against the reference's
XLA ones), unless stated beside the check; greedy ids must be identical.
Then the reference's own xLSTM contracts (``tests/test_models.py:68-123``)
held on the port, and every config of the registry served once.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch import interop
from repro_torch.configs import registry as reg
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

KEY = jax.random.PRNGKey(0)
ZOO = ("xlstm-1.3b", "seamless-m4t-medium", "pixtral-12b")
REL = 1e-5
_J_FORWARD = jax.jit(JT.forward_hidden, static_argnums=(1,))
_J_PREFILL = jax.jit(JT.prefill_with_cache, static_argnums=(1, 3))
_J_DECODE = jax.jit(JT.decode_step, static_argnums=(1,))
_J_ENCODE = jax.jit(JT.encode_for_decode, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel=REL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _port(tree):
    return interop.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@functools.lru_cache(maxsize=None)
def _cfgs(arch, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(jreg.reduce_config(jreg.get_config(arch)),
                                **over),
            dataclasses.replace(reg.reduce_config(reg.get_config(arch)),
                                **over))


@functools.lru_cache(maxsize=None)
def _model(arch, **over):
    """(reference cfg, port cfg, reference params, port params), fp32."""
    jcfg, cfg = _cfgs(arch, **over)
    jp = JT.init_params(jcfg, KEY)
    return jcfg, cfg, jp, _port(jp)


def _batch(cfg, b, s, seed=1, s_enc=8):
    """numpy tokens [b, s] and the config's stub embeddings: the image
    prefix (``num_modal_tokens`` of them) or the encoder's frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    if cfg.modality == "vision":
        batch["modal_embeds"] = rng.standard_normal(
            (b, cfg.num_modal_tokens, cfg.modal_embed_dim)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.standard_normal(
            (b, s_enc, cfg.modal_embed_dim)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# the xLSTM cells


@pytest.mark.parametrize("s", [32, 24], ids=["chunked", "ragged"])
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_mix_and_final_state(cell, s):
    """mlstm_mix / slstm_mix and their final states: S = 32 runs two
    16-step mLSTM chunks, S = 24 (16 does not divide it) one chunk of 24."""
    jcfg, cfg, jp, p = _model("xlstm-1.3b")
    pos = jcfg.block_pattern.index(cell)
    jcell = _layer(jp["blocks"][pos]["cell"])
    tcell = {k: v[0] for k, v in p["blocks"][pos]["cell"].items()}
    x = _x(cfg, 2, s, seed=s)
    jmix = JX.mlstm_mix if cell == "mlstm" else JX.slstm_mix
    mix = X.mlstm_mix if cell == "mlstm" else X.slstm_mix
    want, jstate = jax.jit(functools.partial(jmix, cfg=jcfg,
                                             return_state=True))(
        jcell, x=jnp.asarray(x))
    got, state = mix(tcell, cfg, torch.from_numpy(x), return_state=True)
    _close(got, want)
    assert len(state) == len(jstate)
    for a, b in zip(state, jstate):
        assert a.dtype == torch.float32
        _close(a, b)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_decode_step_updates_state_in_place(cell):
    """One decode step from the state a 16-step mix leaves: the output and
    the new state, written into the caller's tensors."""
    jcfg, cfg, jp, p = _model("xlstm-1.3b")
    pos = jcfg.block_pattern.index(cell)
    jcell = _layer(jp["blocks"][pos]["cell"])
    tcell = {k: v[0] for k, v in p["blocks"][pos]["cell"].items()}
    x, x1 = _x(cfg, 2, 16, seed=3), _x(cfg, 2, 1, seed=4)
    jmix = JX.mlstm_mix if cell == "mlstm" else JX.slstm_mix
    _, jstate = jmix(jcell, jcfg, jnp.asarray(x), return_state=True)
    state = tuple(torch.from_numpy(np.array(a)) for a in jstate)
    if cell == "mlstm":
        want, *jstate = JX.mlstm_decode_step(jcell, jcfg, jnp.asarray(x1),
                                             *jstate)
        got, *new = X.mlstm_decode_step(tcell, cfg, torch.from_numpy(x1),
                                        *state)
    else:
        want, jstate = JX.slstm_decode_step(jcell, jcfg, jnp.asarray(x1),
                                            jstate)
        got, new = X.slstm_decode_step(tcell, cfg, torch.from_numpy(x1),
                                       state)
    assert all(a is b for a, b in zip(new, state))
    _close(got, want)
    for a, b in zip(state, jstate):
        _close(a, b)


# ---------------------------------------------------------------------------
# the encoder and the cross-attention block


def test_xattn_block_and_its_decode():
    """apply_block(kind="xattn+dense", enc_out=) with the prefill's cache,
    then apply_block_decode from that cache: the cross-attention reads
    Skv = 10 encoder positions from S = 12 and then 1 query (no rope, no
    mask)."""
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    jblk = JB.init_block(jax.random.PRNGKey(3), jcfg, "xattn+dense")
    blk = _port(jblk)
    assert set(blk["cross"]) == {"wq", "wk", "wv", "wo"}
    x, enc = _x(cfg, 2, 12, seed=5), _x(cfg, 2, 10, seed=6)
    want, _, jcache = JB.apply_block(jblk, jcfg, "xattn+dense",
                                     jnp.asarray(x), enc_out=jnp.asarray(enc),
                                     cache_len=16)
    got, aux, cache = B.apply_block(blk, cfg, "xattn+dense",
                                    torch.from_numpy(x),
                                    enc_out=torch.from_numpy(enc),
                                    cache_len=16)
    _close(got, want)
    assert float(aux) == 0.0 and set(cache) == set(jcache) == {"k", "v"}
    for name in cache:
        _close(cache[name], jcache[name])
    x1 = _x(cfg, 2, 1, seed=7)
    want, jcache = JB.apply_block_decode(jblk, jcfg, "xattn+dense",
                                         jnp.asarray(x1), jcache, 12,
                                         enc_out=jnp.asarray(enc))
    got, cache = B.apply_block_decode(blk, cfg, "xattn+dense",
                                      torch.from_numpy(x1), cache, 12,
                                      enc_out=torch.from_numpy(enc))
    _close(got, want)
    for name in cache:
        _close(cache[name], jcache[name])
    # the cross-attention alone, q from x and k/v from the encoder
    _close(L.attention(blk["cross"], cfg, torch.from_numpy(x), causal=False,
                       kv_x=torch.from_numpy(enc)),
           JL.attention(jblk["cross"], jcfg, jnp.asarray(x), causal=False,
                        kv_x=jnp.asarray(enc)))


def test_encode():
    jcfg, cfg, jp, p = _model("seamless-m4t-medium")
    src = _batch(cfg, 2, 4, seed=8, s_enc=20)["src_embeds"]
    _close(T._encode(p, cfg, torch.from_numpy(src)),
           jax.jit(JT._encode, static_argnums=(1,))(jp, jcfg,
                                                    jnp.asarray(src)))


# ---------------------------------------------------------------------------
# the three configs end to end


@pytest.mark.parametrize("arch", ZOO)
def test_serving_matches_reference(arch):
    """forward_hidden; prefill_with_cache (hidden states and every cache
    leaf); then the serve builders' greedy ids, the prefill's and 4 decode
    steps' (seamless decoding with encode_for_decode's output), identical
    to the reference's; init_cache's shapes and dtypes."""
    jcfg, cfg, jp, p = _model(arch)
    batch = _batch(cfg, 2, 16)
    jb, tb = _j(batch), _t(batch)
    _close(T.forward_hidden(p, cfg, tb), _J_FORWARD(jp, jcfg, jb))
    s = 16 + (cfg.num_modal_tokens if cfg.modality == "vision" else 0)
    cache_len = s + 8
    jh, jc = _J_PREFILL(jp, jcfg, jb, cache_len)
    h, c = T.prefill_with_cache(p, cfg, tb, cache_len)
    _close(h, jh)
    assert len(c) == len(jc) == len(cfg.block_pattern)
    for pos_c, jpos_c in zip(c, jc):
        assert set(pos_c) == set(jpos_c)
        for name in jpos_c:
            assert pos_c[name].dtype == getattr(torch, str(
                jpos_c[name].dtype))
            _close(pos_c[name], jpos_c[name])
    jenc = _J_ENCODE(jp, jcfg, jb)
    enc = T.encode_for_decode(p, cfg, tb)
    assert (enc is None) == (jenc is None) == (not cfg.is_encoder_decoder)
    if enc is not None:
        _close(enc, jenc)
    jids = jnp.argmax((jh[:, -1] @ JL.unembed_matrix(jp["emb"], jcfg))
                      .astype(jnp.float32), axis=-1).astype(jnp.int32)
    ids, cache = serve.build_prefill_cache_step(cfg, "cpu",
                                                cache_len=cache_len)(p, tb)
    decode = serve.build_decode_step(cfg, "cpu")
    for pos in range(s, s + 4):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        jl, jc = _J_DECODE(jp, jcfg, jc, jids[:, None], jnp.asarray(pos),
                           enc_out=jenc)
        jids = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ids, cache = decode(p, cache, ids[:, None], pos, enc_out=enc)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    shapes = jax.eval_shape(lambda: JT.init_cache(jcfg, 3, 20))
    own = T.init_cache(cfg, 3, 20, device="cpu")
    for pos_c, jpos_c in zip(own, shapes):
        assert {k: (tuple(v.shape), str(v.dtype)[6:])
                for k, v in pos_c.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in jpos_c.items()}
    if cfg.is_xlstm:
        assert bool((own[-1]["m"] == -1e30).all())


@pytest.mark.parametrize("arch", ZOO)
def test_own_init_has_the_reference_tree(arch):
    """The port's own init: the reference's tree, shapes and dtypes (the
    encoder and modal_proj included), and its parameter count, beside
    ``ModelConfig.param_count()`` (which counts cross-attention weights
    that no config builds: seamless's decoder blocks are attn+dense)."""
    jcfg, cfg = _cfgs(arch)
    own = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg, KEY))
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda t: 0, own, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(
                        own, is_leaf=lambda t: isinstance(t, torch.Tensor))):
        assert (tuple(b.shape), str(b.dtype)[6:]) == (a.shape, str(a.dtype))
    n = T.param_count(own)
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes))
    if cfg.is_encoder_decoder:
        # the formula counts a cross-attention a decoder layer and no norm
        # scale; the tree has no cross-attention and 2 scales a block plus
        # the two final norms
        d = cfg.d_model
        xattn = 2 * d * cfg.head_dim * (cfg.num_heads + cfg.num_kv_heads)
        norms = 2 * d * (cfg.num_layers + cfg.num_encoder_layers) + 2 * d
        assert "xattn" not in "".join(cfg.block_pattern)
        assert cfg.param_count() - n == cfg.num_layers * xattn - norms


# ---------------------------------------------------------------------------
# the reference's xLSTM contracts (tests/test_models.py:68-123) on the port


def test_xlstm_prefill_decode_consistency():
    """Teacher-forced decode logits within 2e-3 max|logits| of the full
    forward's (the reference's bound)."""
    _, cfg, _, p = _model("xlstm-1.3b")
    toks = torch.from_numpy(_batch(cfg, 2, 16, seed=9)["tokens"])
    full = T.forward_hidden(p, cfg, {"tokens": toks}) \
        @ L.unembed_matrix(p["emb"], cfg)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    errs = []
    for pos in range(16):
        logits, cache = T.decode_step(p, cfg, cache, toks[:, pos:pos + 1],
                                      pos)
        errs.append(float((logits - full[:, pos]).abs().max()))
    assert max(errs) / (float(full.abs().max()) + 1e-6) < 2e-3, errs


def test_xlstm_prefill_cache_handoff():
    """prefill_with_cache and 4 decode steps == decode from an empty cache
    (rel 1e-4, the reference's bound): the mLSTM memory and the sLSTM
    state hand over exactly."""
    _, cfg, _, p = _model("xlstm-1.3b")
    toks = torch.from_numpy(_batch(cfg, 2, 16, seed=10)["tokens"])
    s = 12
    _, cache = T.prefill_with_cache(p, cfg, {"tokens": toks[:, :s]}, 24)
    c2 = T.init_cache(cfg, 2, 24, device="cpu")
    for pos in range(s):
        _, c2 = T.decode_step(p, cfg, c2, toks[:, pos:pos + 1], pos)
    scale = None
    for pos in range(s, s + 4):
        la, cache = T.decode_step(p, cfg, cache, toks[:, pos:pos + 1], pos)
        lb, c2 = T.decode_step(p, cfg, c2, toks[:, pos:pos + 1], pos)
        scale = scale or float(lb.abs().max()) + 1e-9
        assert float((la - lb).abs().max()) / scale < 1e-4


# ---------------------------------------------------------------------------
# every config of the registry


@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_every_config_serves_on_the_cpu(arch):
    """The port's own init, the serve builders' prefill (with the cache)
    and two greedy decode steps for every registry config, reduced: finite,
    ids in range, no kernel launched on CPU tensors."""
    cfg = reg.reduce_config(reg.get_config(arch))
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _t(_batch(cfg, 2, 8, seed=11))
    s = 8 + (cfg.num_modal_tokens if cfg.modality == "vision" else 0)
    ops.reset_launch_counts()
    ids, cache = serve.build_prefill_cache_step(cfg, "cpu",
                                                cache_len=s + 2)(p, batch)
    enc = T.encode_for_decode(p, cfg, batch)
    decode = serve.build_decode_step(cfg, "cpu")
    for pos in range(s, s + 2):
        ids, cache = decode(p, cache, ids[:, None], pos, enc_out=enc)
        assert ids.shape == (2,) and 0 <= int(ids.min()) \
            and int(ids.max()) < cfg.vocab_size
    assert all(bool(torch.isfinite(c[k]).all()) for c in cache for k in c)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
