"""Block-level assembly (the port of ``repro/models/blocks.py``): a model is
``num_superblocks`` repetitions of ``cfg.block_pattern``, each pattern
position's parameters stacked over superblocks.

Only the dense decoder's block, ``attn+dense``, is ported.  The ``moe``
MLP, ``mamba``, ``mlstm``, ``slstm`` and ``xattn`` mixers raise
``NotImplementedError`` (ROADMAP queue 1 item 16).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _check_kind(kind: str) -> None:
    mixer, _, mlp_kind = kind.partition("+")
    if mixer != "attn" or mlp_kind != "dense":
        raise NotImplementedError(
            f"block kind {kind!r}: only 'attn+dense' (the dense decoder) is "
            f"ported; the moe MLP and the mamba, mlstm, slstm and xattn "
            f"mixers wait for {L.ZOO_ITEM}")


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               device="cpu") -> Dict:
    _check_kind(kind)
    return {"ln1": L.init_rmsnorm(cfg.d_model, device),
            "attn": L.init_attention(gen, cfg, device),
            "ln2": L.init_rmsnorm(cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg, device=device)}


def apply_block(params: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                *, causal: bool = True, enc_out=None, cache_len: int = 0,
                impl: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence block application.  Returns (x, aux_loss, cache|None).

    ``cache_len > 0`` collects this block's decode cache (prefill handoff),
    structured exactly like ``init_block_cache``.  ``impl`` goes to the
    attention core (``ops.flash_attention``)."""
    _check_kind(kind)
    if enc_out is not None:
        raise NotImplementedError(f"enc_out (encoder-decoder) waits for "
                                  f"{L.ZOO_ITEM}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    h_in = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if cache_len > 0:
        h, (k_kv, v_kv) = L.attention(params["attn"], cfg, h_in,
                                      causal=causal,
                                      window=cfg.sliding_window,
                                      return_kv=True, impl=impl)
        ck, cv = L.prefill_kv_cache(cfg, k_kv, v_kv, x.shape[1], cache_len)
        cache = {"k": ck, "v": cv}
    else:
        h = L.attention(params["attn"], cfg, h_in, causal=causal,
                        window=cfg.sliding_window, impl=impl)
    x = x + h
    x = x + L.mlp(params["mlp"], cfg, L.rmsnorm(params["ln2"], x,
                                                cfg.norm_eps))
    return x, aux, cache


# ---------------------------------------------------------------------------
# decode-step application (single token, carried caches)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device="cpu") -> Dict:
    """Cache for ONE layer of the given kind (unstacked)."""
    _check_kind(kind)
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.dtype_of(cfg), device=device)}


def apply_block_decode(params: Dict, cfg: ModelConfig, kind: str,
                       x: torch.Tensor, cache: Dict, pos, *, enc_out=None,
                       axis_name: Optional[str] = None, shard_offset=None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode through one block.  x: [B,1,D].  The cache's
    tensors are updated in place (``layers.decode_attention``) and returned
    in a new dict."""
    _check_kind(kind)
    if enc_out is not None:
        raise NotImplementedError(f"enc_out (encoder-decoder) waits for "
                                  f"{L.ZOO_ITEM}")
    new_cache = dict(cache)
    h, nk, nv = L.decode_attention(
        params["attn"], cfg, L.rmsnorm(params["ln1"], x, cfg.norm_eps),
        cache["k"], cache["v"], pos, window=cfg.sliding_window,
        axis_name=axis_name, shard_offset=shard_offset)
    new_cache["k"], new_cache["v"] = nk, nv
    x = x + h
    return _decode_mlp(params, cfg, kind, x), new_cache


def _decode_mlp(params: Dict, cfg: ModelConfig, kind: str,
                x: torch.Tensor) -> torch.Tensor:
    return x + L.mlp(params["mlp"], cfg, L.rmsnorm(params["ln2"], x,
                                                   cfg.norm_eps))

