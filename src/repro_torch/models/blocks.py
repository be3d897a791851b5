"""Block-level assembly (the port of ``repro/models/blocks.py``): a model is
``num_superblocks`` repetitions of ``cfg.block_pattern``, each pattern
position's parameters stacked over superblocks.

Ported: the ``attn`` and ``mamba`` mixers with the ``dense`` and ``moe``
MLPs (the dense decoders, the MoE decoders and the Jamba hybrid).  The
``mlstm``, ``slstm`` and ``xattn`` mixers raise ``NotImplementedError``
(ROADMAP queue 1 item 16).  Every apply function takes ``tp`` (a
``RankContext``) to the layers: a rank's block runs on its shards.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE

_MIXERS = ("attn", "mamba")
_MLPS = ("dense", "moe")


def _check_kind(kind: str) -> Tuple[str, str]:
    """(mixer, mlp) of a ported block kind; raises for the others."""
    mixer, _, mlp_kind = kind.partition("+")
    if mixer not in _MIXERS or mlp_kind not in _MLPS:
        raise NotImplementedError(
            f"block kind {kind!r}: the attn and mamba mixers with dense or "
            f"moe MLPs are ported; the mlstm, slstm and xattn mixers wait "
            f"for {L.ZOO_ITEM}")
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
    if mixer == "attn":
        p["attn"] = L.init_attention(gen, cfg, device, under("attn"))
    else:
        p["mamba"] = M.init_mamba(gen, cfg, device, under("mamba"))
    p["ln2"] = L.init_rmsnorm(cfg.d_model, device)
    if mlp_kind == "dense":
        p["mlp"] = L.init_mlp(gen, cfg, device=device, cut=under("mlp"))
    else:
        p["moe"] = MOE.init_moe(gen, cfg, device, under("moe"))
    return p


def apply_block(params: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                *, causal: bool = True, enc_out=None, cache_len: int = 0,
                impl: str = "auto", tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence block application.  Returns (x, aux_loss, cache|None).

    ``cache_len > 0`` collects this block's decode cache (prefill handoff),
    structured exactly like ``init_block_cache``.  ``impl`` goes to the
    kernels' routes (``ops.flash_attention``, ``ops.selective_scan``)."""
    mixer, mlp_kind = _check_kind(kind)
    if enc_out is not None:
        raise NotImplementedError(f"enc_out (encoder-decoder) waits for "
                                  f"{L.ZOO_ITEM}")
    cache = None
    h_in = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mixer == "attn" and cache_len > 0:
        h, (k_kv, v_kv) = L.attention(params["attn"], cfg, h_in,
                                      causal=causal,
                                      window=cfg.sliding_window,
                                      return_kv=True, impl=impl, tp=tp)
        ck, cv = L.prefill_kv_cache(cfg, k_kv, v_kv, x.shape[1], cache_len)
        cache = {"k": ck, "v": cv}
    elif mixer == "attn":
        h = L.attention(params["attn"], cfg, h_in, causal=causal,
                        window=cfg.sliding_window, impl=impl, tp=tp)
    elif cache_len > 0:
        h, (ssm, conv) = M.mamba_mix(params["mamba"], cfg, h_in,
                                     return_state=True, impl=impl, tp=tp)
        cache = {"ssm": ssm, "conv": conv}
    else:
        h = M.mamba_mix(params["mamba"], cfg, h_in, impl=impl, tp=tp)
    x, aux = _mlp(params, cfg, mlp_kind, x + h, tp)
    return x, aux, cache


def _mlp(params: Dict, cfg: ModelConfig, mlp_kind: str, x: torch.Tensor,
         tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP half, residual included: (x, aux_loss), the MoE's
    router losses or zero for a dense MLP."""
    h_in = L.rmsnorm(params["ln2"], x, cfg.norm_eps)
    if mlp_kind == "dense":
        return (x + L.mlp(params["mlp"], cfg, h_in, tp),
                torch.zeros((), dtype=torch.float32, device=x.device))
    y, moe_aux = MOE.moe_mlp(params["moe"], cfg, h_in, tp)
    return x + y, MOE.aux_loss(cfg, moe_aux)


# ---------------------------------------------------------------------------
# decode-step application (single token, carried caches)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     cp_shards: int = 1, device="cuda") -> Dict:
    """Cache for ONE layer of the given kind (unstacked): k/v for an
    attention layer, ssm/conv state for a mamba layer.  ``cp_shards``: the
    context-parallel shards the k/v sequence is to be cut in, which it must
    divide (the cache itself is whole, as the reference's)."""
    mixer, _ = _check_kind(kind)
    if mixer == "mamba":
        return {k: v[0] for k, v in M.init_mamba_cache(cfg, batch, 1,
                                                       device).items()}
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    if cp_shards > 1 and s % cp_shards != 0:
        raise ValueError("cache length must divide the context-parallel "
                         "shards")
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device)}


def apply_block_decode(params: Dict, cfg: ModelConfig, kind: str,
                       x: torch.Tensor, cache: Dict, pos, *, enc_out=None,
                       axis_name: Optional[str] = None, shard_offset=None,
                       tp=None) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode through one block.  x: [B,1,D].  The cache's
    tensors are updated in place (``layers.decode_attention``,
    ``mamba.mamba_decode_step``) and returned in a new dict."""
    mixer, mlp_kind = _check_kind(kind)
    if enc_out is not None:
        raise NotImplementedError(f"enc_out (encoder-decoder) waits for "
                                  f"{L.ZOO_ITEM}")
    new_cache = dict(cache)
    h_in = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mixer == "attn":
        h, new_cache["k"], new_cache["v"] = L.decode_attention(
            params["attn"], cfg, h_in, cache["k"], cache["v"], pos,
            window=cfg.sliding_window, axis_name=axis_name,
            shard_offset=shard_offset, tp=tp)
    else:
        h, new_cache["ssm"], new_cache["conv"] = M.mamba_decode_step(
            params["mamba"], cfg, h_in, cache["ssm"], cache["conv"], tp)
    return _mlp(params, cfg, mlp_kind, x + h, tp)[0], new_cache
