"""The port's serving path against the JAX package, on the CPU (fp32,
``reduce_config`` of the dense h2o-danube-1.8b, qwen2-7b and phi3-mini-3.8b,
the Mamba + MoE hybrid jamba-v0.1-52b and the MoE olmoe-1b-7b), and the
reference's own model contracts held on the port.

Params come from the reference's ``T.init_params`` and are carried across
with ``interop.model_params_from_jax``; token ids are drawn with numpy.
Tolerance ``1e-5 * max|reference|`` for every compared tensor (fp32 sums in
other orders and the port's plain attention against the reference's XLA
one), unless stated beside the check; greedy ids must be identical.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import INPUT_SHAPES as J_INPUT_SHAPES
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import registry as reg
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T

KEY = jax.random.PRNGKey(0)
ARCHS = ("h2o-danube-1.8b", "qwen2-7b", "phi3-mini-3.8b")
# the mamba and moe blocks: jamba's (attn+dense, mamba+moe) superblock and
# olmoe's attn+moe (granite-moe's kind too)
HYBRID = ("jamba-v0.1-52b", "olmoe-1b-7b")
# the reference's serving functions, compiled (its eager associative scans
# and MoE dispatch are slow on the CPU)
_J_FORWARD = jax.jit(JT.forward_hidden, static_argnums=(1,))
_J_PREFILL = jax.jit(JT.prefill_with_cache, static_argnums=(1, 3))
_J_DECODE = jax.jit(JT.decode_step, static_argnums=(1,))
REL = 1e-5


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


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_configs_match_reference(arch):
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    red, jred = reg.reduce_config(cfg), jreg.reduce_config(jcfg)
    assert dataclasses.asdict(red) == dataclasses.asdict(jred)
    for c, jc in ((cfg, jcfg), (red, jred)):
        assert c.block_pattern == jc.block_pattern
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()
        for name, shape in INPUT_SHAPES.items():
            assert dataclasses.asdict(shape) == dataclasses.asdict(
                J_INPUT_SHAPES[name])
            assert reg.applicable(c, shape) == jreg.applicable(jc, shape)
    with pytest.raises(KeyError):
        reg.get_config("gpt-2")


# ---------------------------------------------------------------------------
# parity with the reference


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_layer(arch):
    """layers.attention at S = 64 (the reference runs two 32-row query
    chunks), with the config's window, and the cache handoff's k/v."""
    jcfg, cfg, jp, p = _model(arch)
    x = np.random.default_rng(2).standard_normal((2, 64, cfg.d_model)) \
        .astype(np.float32)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]["attn"])
    attn = {k: v[0] for k, v in p["blocks"][0]["attn"].items()}
    want, (jk, jv) = JL.attention(jattn, jcfg, jnp.asarray(x), causal=True,
                                  window=jcfg.sliding_window, return_kv=True)
    got, (k, v) = L.attention(attn, cfg, torch.from_numpy(x), causal=True,
                              window=cfg.sliding_window, return_kv=True)
    _close(got, want)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("arch", ARCHS + HYBRID)
def test_forward_prefill_and_decode(arch):
    """forward_hidden; prefill_with_cache (hidden states and every cache
    leaf: k/v, and ssm/conv for a mamba layer); then four decode_steps
    (logits) from the two caches."""
    jcfg, cfg, jp, p = _model(arch)
    toks = _tokens(cfg, 2, 24)
    _close(T.forward_hidden(p, cfg, {"tokens": torch.from_numpy(toks)}),
           _J_FORWARD(jp, jcfg, {"tokens": jnp.asarray(toks)}))
    s, maxlen = 20, 28
    jh, jc = _J_PREFILL(
        jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])}, maxlen)
    h, c = T.prefill_with_cache(
        p, cfg, {"tokens": torch.from_numpy(toks[:, :s])}, maxlen)
    _close(h, jh)
    for pos_c, jpos_c, kind in zip(c, jc, cfg.block_pattern):
        assert set(pos_c) == set(jpos_c) == (
            {"ssm", "conv"} if kind.startswith("mamba") else {"k", "v"})
        for name in jpos_c:
            assert pos_c[name].dtype == getattr(torch, str(
                jpos_c[name].dtype))
            _close(pos_c[name], jpos_c[name])
    for pos in range(s, s + 4):
        t = toks[:, pos:pos + 1]
        jl, jc = _J_DECODE(jp, jcfg, jc, jnp.asarray(t), jnp.asarray(pos))
        lg, c = T.decode_step(p, cfg, c, torch.from_numpy(t), pos)
        assert lg.dtype == torch.float32
        _close(lg, jl)


@pytest.mark.parametrize("arch", ARCHS + HYBRID)
def test_serve_steps_greedy_ids(arch):
    """The serve builders' greedy ids: prefill without cache, prefill with
    cache, then four decode steps, each identical to the reference's."""
    jcfg, cfg, jp, p = _model(arch)
    mesh = jmesh.make_host_mesh(1, 1)
    toks = _tokens(cfg, 3, 16, seed=4)
    jpre, _ = jserve.build_prefill_step(jcfg, mesh)
    pre = serve.build_prefill_step(cfg, "cpu")
    ids = pre(p, {"tokens": torch.from_numpy(toks)})
    assert ids.dtype == torch.int32 and ids.shape == (3,)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jpre(jp, {"tokens": jnp.asarray(toks)})))
    jprec, _ = jserve.build_prefill_cache_step(jcfg, mesh, 24)
    prec = serve.build_prefill_cache_step(cfg, "cpu", cache_len=24)
    jids, jcache = jprec(jp, {"tokens": jnp.asarray(toks)})
    ids, cache = prec(p, {"tokens": torch.from_numpy(toks)})
    jdec, _ = jserve.build_decode_step(jcfg, mesh)
    dec = serve.build_decode_step(cfg, "cpu")
    for pos in range(16, 20):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        jids, jcache = jdec(jp, jcache, jids[:, None], jnp.asarray(pos))
        ids, cache = dec(p, cache, ids[:, None], pos)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_decode_select_update_matches_reference():
    """decode_cache_update='select' (the masked full-cache write) gives the
    reference's logits and cache, and the port's 'dynamic' write's."""
    jcfg, cfg, jp, p = _model("h2o-danube-1.8b", decode_cache_update="select",
                              sliding_window=8)
    toks = _tokens(cfg, 2, 14, seed=5)
    jc = JT.init_cache(jcfg, 2, 24)
    c = T.init_cache(cfg, 2, 24, device="cpu")
    c_dyn = T.init_cache(dataclasses.replace(cfg,
                                             decode_cache_update="dynamic"),
                         2, 24, device="cpu")
    for pos in range(14):
        t = toks[:, pos:pos + 1]
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(t), jnp.asarray(pos))
        lg, c = T.decode_step(p, cfg, c, torch.from_numpy(t), pos)
        ld, c_dyn = T.decode_step(
            p, dataclasses.replace(cfg, decode_cache_update="dynamic"), c_dyn,
            torch.from_numpy(t), pos)
        _close(lg, jl)
        assert torch.equal(lg, ld)
    _close(c[0]["k"], jc[0]["k"])
    assert torch.equal(c[0]["v"], c_dyn[0]["v"])


def test_cache_layouts_and_kv_expansion_match_reference():
    """init_kv_cache / init_block_cache / init_cache give the reference's
    shapes and dtypes (window 32 caps the cache at 32 slots), and
    _expand_kv repeats each kv head q_per_kv times as jnp.repeat does."""
    from repro.models import blocks as JB
    jcfg, cfg, _, _ = _model("h2o-danube-1.8b")
    jhcfg, hcfg, _, _ = _model("jamba-v0.1-52b")
    pairs = [(L.init_kv_cache(cfg, 2, 48, 3, device="cpu"),
              JL.init_kv_cache(jcfg, 2, 48, 3)),
             (B.init_block_cache(cfg, "attn+dense", 2, 20, device="cpu"),
              JB.init_block_cache(jcfg, "attn+dense", 2, 20)),
             (T.init_cache(cfg, 2, 48, device="cpu")[0],
              JT.init_cache(jcfg, 2, 48)[0]),
             (B.init_block_cache(hcfg, "mamba+moe", 2, 20, device="cpu"),
              JB.init_block_cache(jhcfg, "mamba+moe", 2, 20))]
    pairs += list(zip(T.init_cache(hcfg, 2, 48, device="cpu"),
                      JT.init_cache(jhcfg, 2, 48)))
    for got, want in pairs:
        assert set(got) == set(want)
        for name in want:
            assert tuple(got[name].shape) == want[name].shape
            assert str(got[name].dtype)[6:] == str(want[name].dtype)
            assert not bool(got[name].any())
    k = np.random.default_rng(6).standard_normal((2, 5, 2, 64)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        L._expand_kv(cfg, torch.from_numpy(k)).numpy(),
        np.asarray(JL._expand_kv(jcfg, jnp.asarray(k))))


def test_bf16_params_carry_across_bitwise():
    """interop keeps bfloat16: the port's tree holds the reference's bf16
    bits, and a bf16 forward runs and stays finite."""
    cfg = reg.reduce_config(reg.get_config("h2o-danube-1.8b"))
    jcfg = jreg.reduce_config(jreg.get_config("h2o-danube-1.8b"))
    jp = JT.init_params(jcfg, KEY)
    p = interop.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jwq = np.asarray(jp["blocks"][0]["attn"]["wq"])
    wq = p["blocks"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and isinstance(p["blocks"], tuple)
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(),
                                  jwq.view(np.int16))
    assert p["final_ln"]["scale"].dtype == torch.float32
    h = T.forward_hidden(p, cfg, {"tokens": torch.from_numpy(
        _tokens(cfg, 1, 12))})
    assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all())


def test_bf16_hybrid_params_carry_across_bitwise():
    """The hybrid's whole bf16 tree carries across leaf for leaf with the
    reference's bits: A_log, D, dt_proj_b and the router stay fp32, the
    rest bf16; a bf16 prefill with cache and a decode step run finite."""
    cfg = reg.reduce_config(reg.get_config("jamba-v0.1-52b"))
    jp = JT.init_params(jreg.reduce_config(jreg.get_config(
        "jamba-v0.1-52b")), KEY)
    p = interop.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    fp32 = set()
    for path, want in leaves:
        got = p
        for key in path:
            got = got[key.key if hasattr(key, "key") else key.idx]
        want = np.asarray(want)
        if want.dtype == np.float32:
            fp32.add(str(path[-1].key))
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
    assert fp32 == {"A_log", "D", "dt_proj_b", "router", "scale"}
    toks = torch.from_numpy(_tokens(cfg, 1, 12))
    h, cache = T.prefill_with_cache(p, cfg, {"tokens": toks}, 16)
    assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all())
    mamba_cache = cache[cfg.block_pattern.index("mamba+moe")]
    assert mamba_cache["ssm"].dtype == torch.float32
    assert mamba_cache["conv"].dtype == torch.bfloat16
    lg, _ = T.decode_step(p, cfg, cache, toks[:, -1:], 12)
    assert bool(torch.isfinite(lg).all())


# ---------------------------------------------------------------------------
# the reference's model contracts (tests/test_models.py), on the port


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-7b"] + list(HYBRID))
def test_prefill_decode_consistency(arch):
    """Teacher-forced full-sequence logits match step-by-step decode (the
    reference's bound, 2e-3 of max|logits|), here with a window of 4 that
    the 16 positions overrun, so the rotating cache wraps.  The MoE models
    run capacity_factor 8.0, as the reference's test does: a prefill over
    T tokens may drop pairs that a decode step never drops."""
    over = {"sliding_window": 4} if arch == "h2o-danube-1.8b" else {}
    if arch in HYBRID:
        over = {"capacity_factor": 8.0}
    _, cfg, _, p = _model(arch, **over)
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    full = (T.forward_hidden(p, cfg, {"tokens": toks})
            @ L.unembed_matrix(p["emb"], cfg)).float()
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    errs = []
    for pos in range(16):
        lg, cache = T.decode_step(p, cfg, cache, toks[:, pos:pos + 1], pos)
        errs.append(float((lg - full[:, pos]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-3, errs


@pytest.mark.parametrize("arch,window", [("qwen2-7b", None),
                                         ("h2o-danube-1.8b", 8),
                                         ("jamba-v0.1-52b", None)])
def test_prefill_cache_handoff(arch, window):
    """prefill_with_cache + decode == decode from scratch (the reference's
    bound, 1e-4 of max|logits|); with window 8 the 12-token prefill already
    rotates the cache; jamba hands over the ssm and conv states
    (capacity_factor 8.0, as the reference's test)."""
    over = {"sliding_window": window} if window else {}
    if arch in HYBRID:
        over = {"capacity_factor": 8.0}
    _, cfg, _, p = _model(arch, **over)
    toks = torch.from_numpy(_tokens(cfg, 2, 16))
    _, cache = T.prefill_with_cache(p, cfg, {"tokens": toks[:, :12]}, 24)
    c2 = T.init_cache(cfg, 2, 24, device="cpu")
    for pos in range(12):
        _, c2 = T.decode_step(p, cfg, c2, toks[:, pos:pos + 1], pos)
    for pos in range(12, 16):
        la, cache = T.decode_step(p, cfg, cache, toks[:, pos:pos + 1], pos)
        lb, c2 = T.decode_step(p, cfg, c2, toks[:, pos:pos + 1], pos)
        assert float((la - lb).abs().max()) / float(lb.abs().max()) < 1e-4


def test_sliding_window_masks_old_tokens():
    """With window 4 and 2 layers, hidden states past the receptive field
    (2W - 1 = 7) do not depend on token 0; early ones do."""
    _, cfg, _, p = _model("h2o-danube-1.8b", sliding_window=4)
    t1 = torch.from_numpy(_tokens(cfg, 1, 12, seed=2)).long()
    t2 = t1.clone()
    t2[:, 0] = (t1[:, 0] + 7) % cfg.vocab_size
    h1 = T.forward_hidden(p, cfg, {"tokens": t1})
    h2 = T.forward_hidden(p, cfg, {"tokens": t2})
    diff = (h1 - h2).abs().amax(dim=(0, 2))
    assert float(diff[8:].max()) < 1e-5
    assert float(diff[0]) > 1e-4


# ---------------------------------------------------------------------------
# counts, dispatch and what is not ported


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count(arch):
    """ModelConfig.param_count() counts the weight matrices; the port's tree
    holds exactly those plus the norm scales (and qkv biases)."""
    jcfg, cfg, jp, p = _model(arch)
    n_norm = (2 * cfg.num_layers + 1) * cfg.d_model
    n_bias = (cfg.num_layers * (cfg.num_heads + 2 * cfg.num_kv_heads)
              * cfg.head_dim if cfg.qkv_bias else 0)
    assert T.param_count(p) == cfg.param_count() + n_norm + n_bias
    assert T.param_count(p) == JT.param_count(jp)
    own = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert T.param_count(own) == T.param_count(p)
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))


@pytest.mark.parametrize("arch", HYBRID)
def test_hybrid_param_count_and_tree(arch):
    """The port's own init has the reference's tree and count; the count is
    the formula's plus the norm scales and, per mamba layer, the conv and
    dt biases (which ModelConfig.param_count leaves out)."""
    jcfg, cfg, jp, p = _model(arch)
    n_mamba = cfg.num_superblocks * sum(k.startswith("mamba")
                                        for k in cfg.block_pattern)
    n_norm = (2 * cfg.num_layers + 1) * cfg.d_model
    assert T.param_count(p) == JT.param_count(jp) == (
        cfg.param_count() + n_norm + 2 * cfg.mamba_d_inner * n_mamba)
    own = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert T.param_count(own) == T.param_count(p)
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))


def test_hybrid_prefill_launch_counts_on_cpu():
    """A CPU prefill of the hybrid counts no K6 or K7 launch; impl="kernel"
    forced through the model raises rather than falling back."""
    _, cfg, _, p = _model("jamba-v0.1-52b")
    toks = torch.from_numpy(_tokens(cfg, 1, 8))
    ops.reset_launch_counts()
    T.prefill_with_cache(p, cfg, {"tokens": toks}, 8)
    assert ops.LAUNCH_COUNTS["flash_attention"] == 0
    assert ops.LAUNCH_COUNTS["selective_scan"] == 0
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        M.mamba_mix({k: v[0] for k, v in p["blocks"][1]["mamba"].items()},
                    cfg, torch.zeros((1, 4, cfg.d_model)), impl="kernel")


def test_prefill_counts_no_kernel_launch_on_cpu():
    """On CPU tensors the attention core takes the plain version; impl=
    "kernel" forced through the model raises rather than falling back."""
    _, cfg, _, p = _model("h2o-danube-1.8b")
    toks = torch.from_numpy(_tokens(cfg, 1, 8))
    ops.reset_launch_counts()
    T.forward_hidden(p, cfg, {"tokens": toks})
    assert ops.LAUNCH_COUNTS["flash_attention"] == 0
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        T.forward_hidden(p, cfg, {"tokens": toks}, impl="kernel")


def test_unserved_options_raise():
    """What the port does not serve raises: the softcap, which no config
    sets; a low-precision Mamba scan; the sharded serving options without
    a mesh.  (The xLSTM and encoder-decoder configs serve on a mesh:
    ``tests/test_torch_tp_zoo.py`` holds them to the uncut model.)"""
    _, cfg, _, p = _model("h2o-danube-1.8b")
    # the sharded serving options need a mesh; without one, the sequence
    # axis of a cache is a placement hint only (tests/test_torch_tp_
    # serving.py runs them on a mesh)
    with pytest.raises(ValueError, match="mesh="):
        serve.build_decode_step(cfg, "cpu", context_parallel=True)
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    want, _ = T.decode_step(p, cfg, T.init_cache(cfg, 1, 8, device="cpu"),
                            tok, 0)
    got, _ = T.decode_step(p, dataclasses.replace(
        cfg, decode_cache_seq_axis="m"), cache, tok, 0)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="RankContext"):
        T.decode_step(p, cfg, cache, tok, 1, axis_name="data")
    attn = {k: v[0] for k, v in p["blocks"][0]["attn"].items()}
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="softcap"):
        L.attention(attn, dataclasses.replace(cfg, attn_logit_softcap=30.0), x)
    with pytest.raises(ValueError, match="unknown block kind"):
        B.init_block_cache(cfg, "rnn", 1, 8, device="cpu")
    _, hcfg, _, hp = _model("jamba-v0.1-52b")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="benchmark"):
        T.forward_hidden(hp, dataclasses.replace(
            hcfg, mamba_scan_dtype="bfloat16"), {"tokens": toks})
    # mamba_shard_channels names the channel cut's axis: the same function
    assert torch.equal(
        T.forward_hidden(hp, dataclasses.replace(
            hcfg, mamba_shard_channels="model"), {"tokens": toks}),
        T.forward_hidden(hp, hcfg, {"tokens": toks}))


def test_serve_builders_default_to_the_card():
    cfg = reg.reduce_config(reg.get_config("h2o-danube-1.8b"))
    for build in (serve.build_prefill_step, serve.build_decode_step,
                  serve.build_prefill_cache_step):
        assert inspect.signature(build).parameters["device"].default == "cuda"
    for fn in (T.init_params, T.init_cache, B.init_block_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.build_prefill_cache_step(cfg, cache_len=8)
