"""Block-level assembly (the port of ``repro/models/blocks.py``): a model is
``num_superblocks`` repetitions of ``cfg.block_pattern``, each pattern
position's parameters stacked over superblocks.

Every block kind of the reference: the ``attn``, ``xattn`` (self-attention,
then cross-attention over the encoder's output ``enc_out``), ``mamba``,
``mlstm`` and ``slstm`` mixers, the first three with a ``dense`` or ``moe``
MLP half; the xLSTM blocks carry their own projections and have no MLP
half.  Every apply function takes ``tp`` (a ``RankContext``) to the
layers: a rank's block runs on its shards (an xattn block's
cross-attention, which no config of the zoo has, runs whole on every
rank).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X

_MIXERS = ("attn", "xattn", "mamba", "mlstm", "slstm")
_MLPS = ("dense", "moe")
_CELLS = ("mlstm", "slstm")          # no MLP half
SLSTM_STATE = ("c", "n", "h", "m")


def _check_kind(kind: str) -> Tuple[str, str]:
    """(mixer, mlp) of a block kind; raises ValueError for an unknown
    one."""
    mixer, _, mlp_kind = kind.partition("+")
    if mixer not in _MIXERS or (mixer not in _CELLS
                                and mlp_kind not in _MLPS):
        raise ValueError(f"unknown block kind {kind!r}")
    return mixer, mlp_kind


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               device="cuda", cut=None) -> Dict:
    """One block's parameters; ``cut(path, leaf)`` (path ``"attn/wq"``, ...)
    keeps part of each leaf as it is drawn (``layers._keep``)."""
    mixer, mlp_kind = _check_kind(kind)

    def under(module):
        return None if cut is None else (
            lambda name, t: cut(f"{module}/{name}", t))
    p = {"ln1": L.init_rmsnorm(cfg.d_model, device)}
    if mixer in ("attn", "xattn"):
        p["attn"] = L.init_attention(gen, cfg, device, under("attn"))
    if mixer == "xattn":              # decoder block of an encoder-decoder
        p["ln_x"] = L.init_rmsnorm(cfg.d_model, device)
        p["cross"] = L.init_attention(gen, cfg, device, under("cross"),
                                      cross=True)
    elif mixer == "mamba":
        p["mamba"] = M.init_mamba(gen, cfg, device, under("mamba"))
    elif mixer == "mlstm":
        p["cell"] = X.init_mlstm(gen, cfg, device, under("cell"))
        return p
    elif mixer == "slstm":
        p["cell"] = X.init_slstm(gen, cfg, device, under("cell"))
        return p
    p["ln2"] = L.init_rmsnorm(cfg.d_model, device)
    if mlp_kind == "dense":
        p["mlp"] = L.init_mlp(gen, cfg, device=device, cut=under("mlp"))
    else:
        p["moe"] = MOE.init_moe(gen, cfg, device, under("moe"))
    return p


def _cross(params: Dict, cfg: ModelConfig, x: torch.Tensor, enc_out,
           impl: str) -> torch.Tensor:
    """The xattn block's second residual: non-causal attention of ``x``
    over the encoder's output ``enc_out`` (the reference's ``kv_x``; where
    it is None, over ``x`` itself, as the reference's)."""
    return x + L.attention(params["cross"], cfg,
                           L.rmsnorm(params["ln_x"], x, cfg.norm_eps),
                           causal=False, kv_x=enc_out, impl=impl)


def apply_block(params: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                *, causal: bool = True, enc_out=None, cache_len: int = 0,
                impl: str = "auto", tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence block application.  Returns (x, aux_loss, cache|None).

    ``cache_len > 0`` collects this block's decode cache (prefill handoff),
    structured exactly like ``init_block_cache``.  ``enc_out`` is read by
    an ``xattn`` block only.  ``impl`` goes to the kernels' routes
    (``ops.flash_attention``, ``ops.selective_scan``)."""
    mixer, mlp_kind = _check_kind(kind)
    cache = None
    collect = cache_len > 0
    h_in = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mixer in ("attn", "xattn") and collect:
        h, (k_kv, v_kv) = L.attention(params["attn"], cfg, h_in,
                                      causal=causal,
                                      window=cfg.sliding_window,
                                      return_kv=True, impl=impl, tp=tp)
        ck, cv = L.prefill_kv_cache(cfg, k_kv, v_kv, x.shape[1], cache_len)
        cache = {"k": ck, "v": cv}
    elif mixer in ("attn", "xattn"):
        h = L.attention(params["attn"], cfg, h_in, causal=causal,
                        window=cfg.sliding_window, impl=impl, tp=tp)
    elif mixer == "mamba" and collect:
        h, (ssm, conv) = M.mamba_mix(params["mamba"], cfg, h_in,
                                     return_state=True, impl=impl, tp=tp)
        cache = {"ssm": ssm, "conv": conv}
    elif mixer == "mamba":
        h = M.mamba_mix(params["mamba"], cfg, h_in, impl=impl, tp=tp)
    else:
        mix = X.mlstm_mix if mixer == "mlstm" else X.slstm_mix
        if not collect:
            return x + mix(params["cell"], cfg, h_in, tp=tp), _zero(x), None
        h, state = mix(params["cell"], cfg, h_in, return_state=True, tp=tp)
        names = ("C", "n") if mixer == "mlstm" else SLSTM_STATE
        return x + h, _zero(x), dict(zip(names, state))
    x = x + h
    if mixer == "xattn":
        x = _cross(params, cfg, x, enc_out, impl)
    x, aux = _mlp(params, cfg, mlp_kind, x, tp)
    return x, aux, cache


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _mlp(params: Dict, cfg: ModelConfig, mlp_kind: str, x: torch.Tensor,
         tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP half, residual included: (x, aux_loss), the MoE's
    router losses or zero for a dense MLP."""
    h_in = L.rmsnorm(params["ln2"], x, cfg.norm_eps)
    if mlp_kind == "dense":
        return x + L.mlp(params["mlp"], cfg, h_in, tp), _zero(x)
    y, moe_aux = MOE.moe_mlp(params["moe"], cfg, h_in, tp)
    return x + y, MOE.aux_loss(cfg, moe_aux)


# ---------------------------------------------------------------------------
# decode-step application (single token, carried caches)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     cp_shards: int = 1, device="cuda") -> Dict:
    """Cache for ONE layer of the given kind (unstacked): k/v for an
    attention layer (an xattn block's self-attention), ssm/conv state for a
    mamba layer, C/n for an mLSTM and c/n/h/m for an sLSTM.  ``cp_shards``:
    the context-parallel shards the k/v sequence is to be cut in, which it
    must divide (the cache itself is whole, as the reference's)."""
    mixer, _ = _check_kind(kind)
    if mixer == "mamba":
        return _one(M.init_mamba_cache(cfg, batch, 1, device))
    if mixer == "mlstm":
        return _one(X.init_mlstm_cache(cfg, batch, 1, device))
    if mixer == "slstm":
        return _one(X.init_slstm_cache(cfg, batch, 1, device))
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    if cp_shards > 1 and s % cp_shards != 0:
        raise ValueError("cache length must divide the context-parallel "
                         "shards")
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device)}


def _one(stacked: Dict) -> Dict:
    """The one layer of a stacked cache of one layer."""
    return {k: v[0] for k, v in stacked.items()}


def apply_block_decode(params: Dict, cfg: ModelConfig, kind: str,
                       x: torch.Tensor, cache: Dict, pos, *, enc_out=None,
                       axis_name: Optional[str] = None, shard_offset=None,
                       tp=None) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode through one block.  x: [B,1,D].  The cache's
    tensors are updated in place (``layers.decode_attention``,
    ``mamba.mamba_decode_step``, ``xlstm.*_decode_step``) and returned in
    a new dict.  An xattn block recomputes its cross-attention's k/v from
    ``enc_out`` every step, as the reference does."""
    mixer, mlp_kind = _check_kind(kind)
    new_cache = dict(cache)
    h_in = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mixer in ("attn", "xattn"):
        h, new_cache["k"], new_cache["v"] = L.decode_attention(
            params["attn"], cfg, h_in, cache["k"], cache["v"], pos,
            window=cfg.sliding_window, axis_name=axis_name,
            shard_offset=shard_offset, tp=tp)
    elif mixer == "mamba":
        h, new_cache["ssm"], new_cache["conv"] = M.mamba_decode_step(
            params["mamba"], cfg, h_in, cache["ssm"], cache["conv"], tp)
    elif mixer == "mlstm":
        h, new_cache["C"], new_cache["n"] = X.mlstm_decode_step(
            params["cell"], cfg, h_in, cache["C"], cache["n"], tp)
        return x + h, new_cache
    else:
        h, _ = X.slstm_decode_step(params["cell"], cfg, h_in,
                                   tuple(cache[k] for k in SLSTM_STATE), tp)
        return x + h, new_cache
    x = x + h
    if mixer == "xattn":
        x = _cross(params, cfg, x, enc_out, "auto")
    return _mlp(params, cfg, mlp_kind, x, tp)[0], new_cache
