"""Shared transformer layers (the port of ``repro/models/layers.py``):
RMSNorm, RoPE, GQA attention (full / sliding window / cross-attention over
an encoder's output / single-token decode), the gated MLP, embeddings and
the stub modality projection.

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
XLA.

Training: K6 has no backward (nor has the reference's Pallas kernel, whose
training differentiates the plain XLA attention).  Wherever autograd
records (``records``: grad mode on and an input or parameter requiring
grad), ``attention`` takes the reference's query-chunked core instead
(``_mask_bias``, ``_attend_chunk``; chunks of ``cfg.attn_q_chunk``, each
through ``torch.utils.checkpoint`` under ``cfg.remat``), and
``chunked_softmax_xent`` is the training loss over sequence chunks.

Tensor parallelism: every layer takes an optional ``tp`` (a
``distribution.tensor_parallel.RankContext``) and then runs on its rank's
shard of the parameters (``distribution.sharding.shard_params``): the
attention on the rank's heads (K6 at ``[B, H/M, S, d]``), the MLP on its
d_ff columns, the embedding on its vocabulary rows, each row-parallel
product folded over the model axis in rank order.  Where autograd records,
the replicated input of a rank's cut work passes ``tp.enter`` (``enter_cut``:
its gradient is the fold of the ranks' partials) and a row-parallel output
``tp.fold`` (``fold_cut``: its backward the identity), so every replicated
leaf's gradient comes out whole on every rank; the loss over a cut
vocabulary (``xent_sums(tp=)``) folds the softmax's max, its sum and the
gold logit instead of forming the whole logits.  Decode attention over
a cache cut along its sequence (``cfg.decode_cache_seq_axis``, or the
context-parallel ``axis_name``) folds the softmax's max and sum and the
output across the shards (flash decoding).  With ``tp=None`` every
function is the single-device code.  Under FSDP (``tp.fsdp_axis``) the
layers read whole leaves: ``unshard`` gathers a superblock's leaves cut
over ``data`` before its blocks run.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.sharding import fsdp_dim, tp_plan
from repro_torch.kernels import ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def records(*trees) -> bool:
    """Whether autograd records through a layer: grad mode is on and a
    tensor of ``trees`` (inputs, parameter dicts) requires grad."""
    if not torch.is_grad_enabled():
        return False

    def any_grad(t) -> bool:
        if isinstance(t, torch.Tensor):
            return t.requires_grad
        if isinstance(t, dict):
            return any(any_grad(v) for v in t.values())
        if isinstance(t, (tuple, list)):
            return any(any_grad(v) for v in t)
        return False
    return any(any_grad(t) for t in trees)


def remat(on: bool, fn, *args):
    """``fn(*args)``, through ``torch.utils.checkpoint`` (non-reentrant:
    its activations recomputed in the backward) where ``on`` (a config's
    ``remat``) and grad mode is on; the reference's ``jax.checkpoint``."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The ``torch.dtype`` of ``cfg.dtype`` (a string, as in the reference)."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def _normal(gen: torch.Generator, shape, scale: float, dt: torch.dtype,
            device) -> torch.Tensor:
    """N(0, 1) * scale drawn in fp32 on the generator's device, then cast
    (as the reference casts its fp32 draws) and moved to ``device``; on the
    meta device (the dry run's shapes) nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dt, device=device)
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


def _keep(cut, name: str, t: torch.Tensor) -> torch.Tensor:
    """``cut(name, t)``: the part of a freshly drawn leaf that an init keeps
    (``transformer.init_sharded_params``: one rank's shard); all of it
    without a cut."""
    return t if cut is None else cut(name, t)


def init_attention(gen: torch.Generator, cfg: ModelConfig, device="cuda",
                   cut=None, cross: bool = False):
    """The attention's projections; ``cross=True`` (the decoder's
    cross-attention over the encoder) takes no q/k/v bias, as the
    reference's."""
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg)
    scale = 1.0 / math.sqrt(d)
    p = {
        "wq": _keep(cut, "wq", _normal(gen, (d, h * hd), scale, dt, device)),
        "wk": _keep(cut, "wk", _normal(gen, (d, hkv * hd), scale, dt,
                                       device)),
        "wv": _keep(cut, "wv", _normal(gen, (d, hkv * hd), scale, dt,
                                       device)),
        "wo": _keep(cut, "wo", _normal(gen, (h * hd, d),
                                       scale / math.sqrt(2 * cfg.num_layers),
                                       dt, device)),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = _keep(cut, name, torch.zeros((n,), dtype=dt,
                                                   device=device))
    return p


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor, kv_x=None):
    """Returns q [B,S,H,Dh] from ``x`` and k/v [B,Skv,Hkv,Dh] from ``kv_x``
    (``x`` where it is None; a rank's shard: its heads, the head counts
    read from the projections' widths)."""
    b, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    skv = kv_x.shape[1]
    q = x @ params["wq"]
    k = kv_x @ params["wk"]
    v = kv_x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, skv, -1, cfg.head_dim)
    v = v.reshape(b, skv, -1, cfg.head_dim)
    return q, k, v


def local_kv_heads(cfg: ModelConfig, model: int, m: int) -> list:
    """The kv heads that rank ``m``'s q heads read, where the kv heads are
    not cut (``tp_plan(...).kv`` False, the kv projections whole on every
    rank): one kv head a group of q heads, in order; the rank's q heads
    then group evenly over them (``len`` divides H / model)."""
    hl, g = cfg.num_heads // model, cfg.q_per_kv
    first = m * hl
    if hl % g == 0:
        return list(range(first // g, (first + hl) // g))
    if g % hl == 0:
        return [first // g]
    return [(first + i) // g for i in range(hl)]


def _rank_kv(cfg: ModelConfig, tp, k: torch.Tensor, v: torch.Tensor):
    """The kv heads (axis 2) a rank's q heads read: all of k/v where they
    are the rank's shard, else the rank's ``local_kv_heads`` of the whole
    k/v, which enter the rank's work there (``tp.enter``)."""
    if tp is None or tp.model == 1:
        return k, v
    plan = tp_plan(cfg, tp.model)
    if plan.kv or not plan.heads:
        return k, v
    k, v = tp.enter(k), tp.enter(v)
    idx = local_kv_heads(cfg, tp.model, tp.m)
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return (k.narrow(2, idx[0], len(idx)), v.narrow(2, idx[0], len(idx)))
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def cuts(cfg: ModelConfig, tp, module: str) -> bool:
    """Whether ``tp``'s plan cuts ``module`` over the model axis."""
    return (tp is not None and tp.model > 1
            and getattr(tp_plan(cfg, tp.model), module))


def fold_cut(cfg: ModelConfig, partial: torch.Tensor, tp,
             module: str) -> torch.Tensor:
    """A row-parallel product's partial (the contracted dim cut), folded
    over the model axis where the plan cuts ``module``; else the whole
    product, as it is."""
    return tp.fold(partial) if cuts(cfg, tp, module) else partial


def enter_cut(cfg: ModelConfig, x: torch.Tensor, tp,
              module: str) -> torch.Tensor:
    """A replicated ``x`` entering the rank's part of ``module`` (a
    column-parallel product): ``tp.enter`` where the plan cuts it, whose
    backward folds the ranks' partial gradients of ``x``."""
    return tp.enter(x) if cuts(cfg, tp, module) else x


def unshard(cfg: ModelConfig, tree, tp):
    """A tree of parameter dicts (a superblock's blocks, the embeddings)
    with every leaf that FSDP cuts over ``tp.fsdp_axis``
    (``sharding.fsdp_dim``) gathered whole, in one collective
    (``RankContext.unshard``); the tree itself without FSDP."""
    if tp is None or tp.fsdp_axis is None:
        return tree
    data = tp.size(tp.fsdp_axis)

    def walk(t, names, leaf_fn):
        if isinstance(t, dict):
            return {k: walk(v, names + (k,), leaf_fn) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, names, leaf_fn) for v in t)
        dim = fsdp_dim(names, t.dim(), cfg, data)
        return t if dim is None else leaf_fn(t, dim)

    cut = []
    walk(tree, (), lambda t, dim: cut.append((t, dim)))
    if not cut:
        return tree
    whole = iter(tp.unshard([t for t, _ in cut], [d for _, d in cut],
                            tp.fsdp_axis))
    return walk(tree, (), lambda t, dim: next(whole))


def _expand_kv(cfg: ModelConfig, k: torch.Tensor,
               heads: Optional[int] = None) -> torch.Tensor:
    """[B,S,Hkv,Dh] -> [B,S,H,Dh] by repeating each kv head q_per_kv times
    (or ``heads`` / Hkv times: a rank's q heads over the kv heads they
    read): the layout the reference's kernel takes.  The port's attention
    core reads the grouped kv as it is, without this copy."""
    rep = cfg.q_per_kv if heads is None else heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive mask bias [len(q_pos), len(k_pos)] in fp32: 0 where a
    query may attend a key, -1e30 elsewhere."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
    return torch.where(ok, 0.0, -1e30).float()


def _attend_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """q: [B,C,H,Dh], k/v: [B,Skv,H,Dh] (heads expanded), bias: [C,Skv].
    fp32 scores and softmax; the output [B,C,H,Dh] in v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores + bias[None, None, :, :], dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _train_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, causal: bool, window: Optional[int]
                     ) -> torch.Tensor:
    """The reference's query-chunked attention core, differentiable: q
    [B,S,H,Dh] against the grouped k/v [B,Skv,Hkv,Dh] expanded to H heads
    (a rank's: its q heads over the kv heads they read), chunks of
    ``cfg.attn_q_chunk`` queries (one chunk of all S where it does not
    divide S), each checkpointed under ``cfg.remat``.  Query i sits at
    position i and key j at j (self-attention and the encoder; a
    cross-attention is neither causal nor windowed, so no pair is
    masked).  Returns [B,S,H,Dh] in v's dtype."""
    s, skv = q.shape[1], k.shape[1]
    k, v = _expand_kv(cfg, k, q.shape[2]), _expand_kv(cfg, v, q.shape[2])
    cq = min(cfg.attn_q_chunk, s)
    if s % cq != 0:
        cq = s
    k_pos = torch.arange(skv, device=q.device)

    def one_chunk(qc, lo):
        q_pos = torch.arange(lo, lo + cq, device=q.device)
        return _attend_chunk(qc, k, v, _mask_bias(q_pos, k_pos, causal,
                                                  window))

    return torch.cat([remat(cfg.remat, one_chunk, q[:, lo:lo + cq], lo)
                      for lo in range(0, s, cq)], dim=1)


def attention(params, cfg: ModelConfig, x: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              return_kv: bool = False, kv_x=None, impl: str = "auto",
              tp=None):
    """Full-sequence attention.  x: [B,S,D] -> [B,S,D].

    The core is ``ops.flash_attention`` on [B, H, S, d] q and the grouped
    [B, Hkv, Skv, d] k/v (K6 on the card; ``impl`` forces the kernel or the
    plain version, as ``ops`` does).  Self-attention by default, rope'd at
    positions 0..S-1.  ``kv_x`` [B,Skv,D] makes it cross-attention (the
    ``xattn`` block over the encoder's output): q from ``x``, k/v from
    ``kv_x``, no rope; callers pass ``causal=False`` and no window, so no
    pair is masked and the reference's ``positions``/``kv_positions``
    (which only place its mask) have no counterpart here.
    ``return_kv=True`` additionally returns the (rope'd, unexpanded) k/v
    [B,Skv,Hkv,Dh] for the prefill->decode cache handoff.  With ``tp`` the
    rank's heads run (the returned k/v are the rank's cache heads) and
    ``wo``'s partials fold.  Where autograd records (``records``) the core
    is the differentiable ``_train_attention`` instead, unless ``impl``
    forces the kernel, whose wrapper then raises (K6 has no backward)."""
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError(
            "attn_logit_softcap: no config sets it, and K6 has no softcap in "
            "the reference either")
    b, s, _ = x.shape
    # the rank's q heads (and kv heads, where they are cut) read x through
    # ``enter``; whole k/v enter at the rank's selection (``_rank_kv``)
    x_in = enter_cut(cfg, x, tp, "heads")
    q, k, v = _project_qkv(params, cfg, x_in, kv_x if kv_x is not None
                           else x_in if cuts(cfg, tp, "kv") else x)
    if kv_x is None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    k_use, v_use = _rank_kv(cfg, tp, k, v)
    if impl != "kernel" and records(x, kv_x, params):
        out = _train_attention(cfg, q, k_use, v_use, causal, window)
    else:
        out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                                  k_use.transpose(1, 2).contiguous(),
                                  v_use.transpose(1, 2).contiguous(),
                                  causal=causal, window=window,
                                  impl=impl).transpose(1, 2)
    out = out.reshape(b, s, -1)
    out = fold_cut(cfg, out @ params["wo"], tp, "heads")
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
                     axis_name: Optional[str] = None, shard_offset=None,
                     tp=None):
    """Single-token decode.  x: [B,1,D]; cache_k/v: [B,Scache,Hkv,Dh]; pos:
    the current position (an int, or a 0-d tensor read on the host).
    Returns (out [B,1,D], cache_k, cache_v), the caches updated in place at
    the new token's slot (``cfg.decode_cache_update``: "dynamic" writes the
    slot, "select" rewrites the whole cache through a mask, as the
    reference does for a sharded cache).

    With ``window`` set the cache is a rotating buffer and the slot is
    ``pos % Scache``.  With ``tp`` the rank's heads attend over its cache
    shard.  The cache's sequence is cut over a mesh axis in two cases:
    ``axis_name`` (context-parallel decode over ``data``; ``shard_offset``
    is the global position of this shard's first slot) and
    ``cfg.decode_cache_seq_axis`` (the kv heads do not divide over
    ``model``, so the sequence is cut over it).  Each shard then writes the
    new token only where it owns the slot, forms its scores (over every q
    head, gathered, where the cut is over ``model``), and the softmax's
    max, its sum and the output fold across the shards in rank order
    (flash decoding).  Without ``tp`` ``decode_cache_seq_axis`` is a
    placement hint and changes nothing."""
    if cfg.attn_logit_softcap is not None:
        raise NotImplementedError("attn_logit_softcap: no config sets it")
    if cfg.decode_cache_update not in ("dynamic", "select"):
        raise ValueError(f"unknown decode_cache_update "
                         f"{cfg.decode_cache_update!r}")
    if axis_name is not None and (tp is None or shard_offset is None):
        raise ValueError("context-parallel decode (axis_name) runs on one "
                         "rank of a mesh: pass tp (a RankContext) and "
                         "shard_offset")
    seq_axis = axis_name
    if seq_axis is None and tp is not None:
        seq_axis = cfg.decode_cache_seq_axis
    if seq_axis is not None and tp.size(seq_axis) == 1:
        seq_axis = None
    pos = int(pos)
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, cfg, x)
    posv = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    if seq_axis is not None:
        out = _decode_sharded_seq(cfg, q, k_new, v_new, cache_k, cache_v,
                                  pos, window, seq_axis, shard_offset, tp)
        out = out.reshape(b, 1, -1).to(x.dtype) @ params["wo"]
        return fold_cut(cfg, out, tp, "heads"), cache_k, cache_v

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
    k_use, v_use = _rank_kv(cfg, tp, cache_k, cache_v)
    hl, hkv, dh = q.shape[2], k_use.shape[2], cfg.head_dim
    qg = q.reshape(b, hkv, hl // hkv, dh).float()
    scores = torch.einsum("bjgd,bkjd->bjgk", qg, k_use.float()) \
        / math.sqrt(dh)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bjgk,bkjd->bjgd", probs.to(v_use.dtype), v_use)
    out = out.reshape(b, 1, hl * dh).to(x.dtype) @ params["wo"]
    return fold_cut(cfg, out, tp, "heads"), cache_k, cache_v


def _decode_sharded_seq(cfg: ModelConfig, q, k_new, v_new, cache_k, cache_v,
                        pos: int, window, seq_axis: str, shard_offset, tp
                        ) -> torch.Tensor:
    """Decode attention over a cache whose sequence is cut over
    ``seq_axis``: the rank's slots are written where it owns the new
    token's slot, and the flash-decoding partials (max, rescaled sum,
    output) fold across the shards.  Returns the rank's heads' output
    [B, 1, H_rank, dh] in fp32."""
    b, dev = q.shape[0], q.device
    s_local = cache_k.shape[1]
    shards = tp.size(seq_axis)
    context = seq_axis != "model"
    offset = (int(shard_offset) if context
              else tp.coord(seq_axis) * s_local)
    gidx = offset + torch.arange(s_local, device=dev)
    if context:
        # the reference's context-parallel slot rule (no rotating buffer)
        slot = pos % s_local if window else pos
    else:
        slot = pos % (s_local * shards) if window else pos
    sel = (gidx == slot)[None, :, None, None]
    cache_k.copy_(torch.where(sel, k_new.to(cache_k.dtype), cache_k))
    cache_v.copy_(torch.where(sel, v_new.to(cache_v.dtype), cache_v))
    kpos = gidx
    if context:
        valid = kpos <= pos
    else:
        if window:
            s_all = s_local * shards
            kpos = torch.where(gidx <= slot, pos - slot + gidx,
                               pos - slot - s_all + gidx)
        valid = (kpos >= 0) & (kpos <= pos)
        if window:
            valid = valid & (pos - kpos < window)
    bias = torch.where(valid, 0.0, -1e30).float()
    hl = q.shape[2]
    # a sequence cut over the model axis holds every head: its shard
    # attends with every q head
    gathered = (not context and tp_plan(cfg, tp.model).heads
                and tp.model > 1)
    if gathered:
        q = tp.gather(q, "model")                     # [M, B, 1, hl, dh]
        q = q.permute(1, 2, 0, 3, 4).reshape(b, 1, tp.model * hl, -1)
        k_use, v_use = cache_k, cache_v
    else:
        k_use, v_use = _rank_kv(cfg, tp, cache_k, cache_v)
    hq, hkv, dh = q.shape[2], k_use.shape[2], cfg.head_dim
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    scores = (torch.einsum("bjgd,bkjd->bjgk", qg, k_use.float())
              * (1.0 / math.sqrt(dh)) + bias)
    m_glob = tp.fold(torch.amax(scores, dim=-1, keepdim=True), seq_axis,
                     torch.maximum)
    p = torch.exp(scores - m_glob)
    num = torch.einsum("bjgk,bkjd->bjgd", p.to(v_use.dtype), v_use).float()
    den = torch.sum(p, dim=-1, keepdim=True)
    num = tp.fold(num, seq_axis)
    den = tp.fold(den, seq_axis)
    out = (num / torch.clamp(den, min=1e-30)).reshape(b, 1, hq, dh)
    if gathered:
        out = out[:, :, tp.m * hl:(tp.m + 1) * hl]
    return out


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, device="cuda", cut=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "w_gate": _keep(cut, "w_gate", _normal(gen, (d, f), 1.0 / math.sqrt(d),
                                               dt, device)),
        "w_up": _keep(cut, "w_up", _normal(gen, (d, f), 1.0 / math.sqrt(d),
                                           dt, device)),
        "w_down": _keep(cut, "w_down", _normal(
            gen, (f, d), 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.num_layers),
            dt, device)),
    }


def mlp(params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The gated MLP; with ``tp`` on the rank's d_ff columns, ``w_down``'s
    partials folded."""
    # the reference's jax.nn.gelu is the tanh approximation by default
    act = F.silu if cfg.mlp_act == "silu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    x = enter_cut(cfg, x, tp, "mlp")
    out = (act(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]
    return fold_cut(cfg, out, tp, "mlp")


# ---------------------------------------------------------------------------
# embeddings / unembedding


def init_embeddings(gen: torch.Generator, cfg: ModelConfig, device="cuda",
                    cut=None):
    dt = dtype_of(cfg)
    p = {"tok": _keep(cut, "tok", _normal(gen, (cfg.vocab_size, cfg.d_model),
                                          0.02, dt, device))}
    if not cfg.tie_embeddings:
        p["unemb"] = _keep(cut, "unemb", _normal(
            gen, (cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model),
            dt, device))
    if cfg.modality:
        # the stub frontend's projection of precomputed patch (vision) or
        # frame (audio) embeddings into the model's width
        p["modal_proj"] = _keep(cut, "modal_proj", _normal(
            gen, (cfg.modal_embed_dim, cfg.d_model),
            1.0 / math.sqrt(cfg.modal_embed_dim), dt, device))
    return p


def embed(params, cfg: ModelConfig, tokens: torch.Tensor, tp=None
          ) -> torch.Tensor:
    """The token embeddings; with ``tp`` and the vocabulary cut, each rank
    looks up its rows (zero for a token outside them) and the shards fold:
    one of the summands is the row, the others zero, so the fold is
    exact."""
    if tp is None or tp.model == 1 or not tp_plan(cfg, tp.model).vocab:
        return params["tok"][tokens]
    rows = params["tok"].shape[0]
    local = tokens - tp.m * rows
    hit = (local >= 0) & (local < rows)
    x = params["tok"][local.clamp(0, rows - 1)]
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return tp.fold(x)


def unembed_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["tok"].T if cfg.tie_embeddings else params["unemb"]


def xent_sums(x: torch.Tensor, w_unemb: torch.Tensor, labels: torch.Tensor,
              chunk: int, mask=None, remat_chunks: bool = False, tp=None):
    """(sum of the masked token NLLs, sum of the mask), both 0-d fp32:
    ``chunked_softmax_xent``'s numerator and denominator.

    With ``tp`` (the vocabulary cut over the model axis, ``w_unemb`` the
    rank's columns) each rank forms its own logits only: the row max is
    folded with ``torch.maximum`` (no gradient: the log-sum-exp does not
    depend on it), the exp-sums are folded, and the gold logit is folded
    from the rank that holds it.  Each chunk is a scope of the rank's
    collectives, so that its recompute replays them."""
    b, s, _ = x.shape
    c = min(chunk, s)
    if s % c != 0:
        c = s
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.to(device=x.device, dtype=torch.float32)
    labels = labels.to(device=x.device, dtype=torch.int64)
    if tp is not None:
        x = tp.enter(x)

    def whole(lg, ll):
        lse = torch.logsumexp(lg, dim=-1)
        return lse, torch.gather(lg, -1, ll[..., None])[..., 0]

    def cut(lg, ll):
        v = lg.shape[-1]
        mx = tp.fold(torch.amax(lg, dim=-1), op=torch.maximum)
        lse = mx + torch.log(tp.fold(torch.sum(torch.exp(lg - mx[..., None]),
                                               dim=-1)))
        local = ll - tp.m * v
        hit = (local >= 0) & (local < v)
        mine = torch.gather(lg, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        return lse, tp.fold(torch.where(hit, mine, torch.zeros_like(mine)))

    def one(xx, ll, mm, lo):
        lg = (xx @ w_unemb).float()
        if tp is None:
            lse, gold = whole(lg, ll)
        else:
            with tp.scope(("xent", lo)):
                lse, gold = cut(lg, ll)
        return torch.sum((lse - gold) * mm), torch.sum(mm)

    nll, cnt = [], []
    for lo in range(0, s, c):
        args = (x[:, lo:lo + c], labels[:, lo:lo + c], mask[:, lo:lo + c], lo)
        n, m = remat(remat_chunks, one, *args)
        nll.append(n)
        cnt.append(m)
    return torch.sum(torch.stack(nll)), torch.sum(torch.stack(cnt))


def chunked_softmax_xent(x: torch.Tensor, w_unemb: torch.Tensor,
                         labels: torch.Tensor, chunk: int, mask=None, *,
                         remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy without materialising [B,S,V] logits.

    x: [B,S,D] final hidden states; labels: [B,S] int; mask: [B,S] (None:
    every position).  Chunks of ``chunk`` positions (one chunk of all S
    where it does not divide S); each chunk's fp32 logits [B,c,V] live
    transiently (recomputed in the backward under ``remat``).  Returns the
    mean NLL over the mask: its masked sum over the mask's count floored at
    1 (0-d fp32)."""
    nll, cnt = xent_sums(x, w_unemb, labels, chunk, mask, remat)
    return nll / torch.clamp(cnt, min=1.0)


def logits(params, cfg: ModelConfig, x: torch.Tensor, tp=None
           ) -> torch.Tensor:
    """fp32 logits [..., vocab] of final hidden states ``x`` [..., D]; with
    ``tp`` and the vocabulary cut, each rank's columns gathered in rank
    order (exact: the vocabulary's order, so an argmax keeps the lowest
    index of a tie)."""
    out = (x @ unembed_matrix(params, cfg)).float()
    if tp is None or tp.model == 1 or not tp_plan(cfg, tp.model).vocab:
        return out
    parts = tp.gather(out, "model")                  # [M, ..., V/M]
    return torch.cat(list(parts.unbind(0)), dim=-1)
