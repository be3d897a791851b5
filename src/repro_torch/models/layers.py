"""Shared transformer layers of the dense decoders (the port of
``repro/models/layers.py``): RMSNorm, RoPE, GQA attention (full / sliding
window / single-token decode), the gated MLP, embeddings.

Functional style, as the reference: ``init_*`` builds parameter dicts of
tensors, the apply functions are pure, except that ``decode_attention``
writes the new token's k/v into the caller's cache in place (the reference
returns a new cache; the port saves a copy of the cache per step).

The full-sequence attention core runs through ``kernels.ops.
flash_attention``: the hand-written Hopper kernel (K6) for CUDA tensors,
the plain chunked version for CPU ones.  The reference computes the same
function in plain XLA, query-chunked, and holds it equal to its Pallas
kernel (``tests/test_kernels.py::test_matches_model_layer_path``).  Decode
attention over the cache is plain PyTorch, as the reference leaves it to
XLA.  ``chunked_softmax_xent`` waits for the port's training step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# what an unported path names when it raises
MESH_ITEM = "ROADMAP queue 1 item 15 (distribution/)"
ZOO_ITEM = "ROADMAP queue 1 item 16 (model zoo)"


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The ``torch.dtype`` of ``cfg.dtype`` (a string, as in the reference)."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def _normal(gen: torch.Generator, shape, scale: float, dt: torch.dtype,
            device) -> torch.Tensor:
    """N(0, 1) * scale drawn in fp32 on the generator's device, then cast
    (as the reference casts its fp32 draws) and moved to ``device``."""
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(device=device, dtype=dt)


# ---------------------------------------------------------------------------
# norms


def init_rmsnorm(d: int, device="cuda"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings


def rope_frequencies(head_dim: int, theta: float, device="cuda"
                     ) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [Dh/2]
    angles = positions.to(x.device)[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]               # [.., S, 1, Dh/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def init_attention(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg)
    scale = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, h * hd), scale, dt, device),
        "wk": _normal(gen, (d, hkv * hd), scale, dt, device),
        "wv": _normal(gen, (d, hkv * hd), scale, dt, device),
        "wo": _normal(gen, (h * hd, d),
                      scale / math.sqrt(2 * cfg.num_layers), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt, device=device)
    return p


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor):
    """Returns q [B,S,H,Dh], k/v [B,S,Hkv,Dh]."""
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _expand_kv(cfg: ModelConfig, k: torch.Tensor) -> torch.Tensor:
    """[B,S,Hkv,Dh] -> [B,S,H,Dh] by repeating each kv head q_per_kv times:
    the layout the reference's kernel takes.  The port's attention core
    reads the grouped kv as it is, without this copy."""
    if cfg.q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, cfg.q_per_kv, dim=2)


def attention(params, cfg: ModelConfig, x: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              return_kv: bool = False, kv_x=None, impl: str = "auto"):
    """Full-sequence self-attention.  x: [B,S,D] -> [B,S,D].

    The core is ``ops.flash_attention`` on [B, H, S, d] q and the grouped
    [B, Hkv, S, d] k/v (K6 on the card; ``impl`` forces the kernel or the
    plain version, as ``ops`` does).  ``return_kv=True`` additionally
    returns the (rope'd, unexpanded) k/v [B,S,Hkv,Dh] for the
    prefill->decode cache handoff.  Query/key positions are 0..S-1; the
    reference's ``positions``/``kv_positions`` serve its cross-attention
    decode only."""
    if kv_x is not None:
        raise NotImplementedError(
            f"cross-attention (kv_x, encoder-decoder) waits for {ZOO_ITEM}")
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError(
            "attn_logit_softcap: no config sets it, and K6 has no softcap in "
            "the reference either")
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x)
    pos = torch.arange(s, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=causal, window=window, impl=impl)
    out = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    out = out @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


def prefill_kv_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                     seq_len: int, cache_len: int):
    """Arrange prefill k/v [B,S,Hkv,dh] into the decode cache layout.

    Full attention: left-aligned, zero-padded to cache_len.  Sliding window:
    a rotating buffer whose slot i holds the latest position p < S with
    p % W == i -- what decode_attention's slot arithmetic expects."""
    b, s, hkv, dh = k.shape
    if cfg.sliding_window:
        w = min(cache_len, cfg.sliding_window)
        slots = torch.arange(w, device=k.device)
        # the latest p < s with p % w == slot
        p = s - 1 - torch.remainder(s - 1 - slots, w)
        valid = ((p >= 0) & (p < s))[None, :, None, None]
        idx = p.clamp(min=0)
        ck = torch.where(valid, k[:, idx], torch.zeros((), dtype=k.dtype,
                                                       device=k.device))
        cv = torch.where(valid, v[:, idx], torch.zeros((), dtype=v.dtype,
                                                       device=v.device))
        return ck, cv
    pad = cache_len - s
    if pad > 0:
        return F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))
    return k[:, :cache_len], v[:, :cache_len]


# --- decode path -------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=None, device="cuda"):
    """Stacked KV cache for the layer stack: [L, B, S, Hkv, Dh]."""
    dt = dtype or dtype_of(cfg)
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    shape = (n_layers, batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(params, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos, *,
                     window: Optional[int] = None,
                     axis_name: Optional[str] = None, shard_offset=None):
    """Single-token decode.  x: [B,1,D]; cache_k/v: [B,Scache,Hkv,Dh]; pos:
    the current position (an int, or a 0-d tensor read on the host).
    Returns (out [B,1,D], cache_k, cache_v), the caches updated in place at
    the new token's slot (``cfg.decode_cache_update``: "dynamic" writes the
    slot, "select" rewrites the whole cache through a mask, as the
    reference does for a sharded cache).

    With ``window`` set the cache is a rotating buffer and the slot is
    ``pos % Scache``.  The reference's sharded branches
    (``cfg.decode_cache_seq_axis``, ``axis_name``) raise."""
    if axis_name is not None or shard_offset is not None:
        raise NotImplementedError(
            f"context-parallel decode (axis_name) waits for {MESH_ITEM}")
    if cfg.decode_cache_seq_axis is not None:
        raise NotImplementedError(
            f"decode_cache_seq_axis (a sequence-sharded cache) waits for "
            f"{MESH_ITEM}")
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError("attn_logit_softcap: no config sets it")
    if cfg.decode_cache_update not in ("dynamic", "select"):
        raise ValueError(f"unknown decode_cache_update "
                         f"{cfg.decode_cache_update!r}")
    pos = int(pos)
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, cfg, x)
    posv = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)

    s_cache = cache_k.shape[1]
    slot = pos % s_cache if window else pos
    if cfg.decode_cache_update == "select":
        sel = (torch.arange(s_cache, device=x.device) == slot)[None, :, None,
                                                               None]
        cache_k.copy_(torch.where(sel, k_new.to(cache_k.dtype), cache_k))
        cache_v.copy_(torch.where(sel, v_new.to(cache_v.dtype), cache_v))
    else:
        cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    kpos = torch.arange(s_cache, device=x.device)
    if window:
        # rotating buffer: slot i holds the latest position p with p % W == i
        kpos = torch.where(kpos <= slot, pos - slot + kpos,
                           pos - slot - s_cache + kpos)
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (pos - kpos < window)

    # plain attention of the one query over the cache, fp32 scores, grouped
    # heads (query head h reads kv head h // q_per_kv)
    hkv, g, dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    qg = q.reshape(b, hkv, g, dh).float()
    scores = torch.einsum("bjgd,bkjd->bjgk", qg, cache_k.float()) \
        / math.sqrt(dh)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bjgk,bkjd->bjgd", probs.to(cache_v.dtype), cache_v)
    out = out.reshape(b, 1, cfg.num_heads * dh).to(x.dtype) @ params["wo"]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, device="cuda"):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "w_gate": _normal(gen, (d, f), 1.0 / math.sqrt(d), dt, device),
        "w_up": _normal(gen, (d, f), 1.0 / math.sqrt(d), dt, device),
        "w_down": _normal(gen, (f, d),
                          1.0 / math.sqrt(f) / math.sqrt(2 * cfg.num_layers),
                          dt, device),
    }


def mlp(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu is the tanh approximation by default
    act = F.silu if cfg.mlp_act == "silu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    return (act(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings / unembedding


def init_embeddings(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    dt = dtype_of(cfg)
    p = {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                        device)}
    if not cfg.tie_embeddings:
        p["unemb"] = _normal(gen, (cfg.d_model, cfg.vocab_size),
                             1.0 / math.sqrt(cfg.d_model), dt, device)
    if cfg.modality:
        raise NotImplementedError(
            f"modality embeddings ({cfg.modality}) wait for {ZOO_ITEM}")
    return p


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["tok"].T if cfg.tie_embeddings else params["unemb"]
