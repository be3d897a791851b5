"""Top-level model API of the dense decoders (the port of
``repro/models/transformer.py``): init, prefill (hidden states, or hidden
states plus the decode cache) and single-token decode.

Params keep the reference's tree, ``{"emb", "blocks": tuple per pattern
position of dicts stacked over superblocks, "final_ln"}``, so weights carry
across with a tree map (``repro_torch.interop.model_params_from_jax``).
The reference's depth ``lax.scan`` is a Python loop over the superblock
index.  The serving functions run under ``torch.inference_mode()``.
``forward_loss`` waits for the port's training step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

PyTree = Any


def _at(tree, i: int):
    """Superblock ``i`` of a dict of stacked tensors."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    """One dict of stacked tensors from a list of like dicts."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Random parameters with the reference's shapes, scales and dtypes.

    Every normal is drawn in fp32 from ``generator`` on the generator's own
    device, then cast to ``cfg.dtype`` and moved to ``device``: a CUDA
    generator draws a full-size model's weights on the card in well under a
    second, where a CPU generator takes seconds per GB (``chip_smoke.py``
    draws h2o-danube-1.8b on ``torch.Generator(device="cuda")``).  The
    draws differ from the reference's threefry streams; the parity tests
    carry the reference's weights across instead."""
    _check_decoder_only(cfg)
    emb = L.init_embeddings(generator, cfg, device)
    per_pos = []
    for kind in cfg.block_pattern:
        per_pos.append(_stack([B.init_block(generator, cfg, kind, device)
                               for _ in range(cfg.num_superblocks)]))
    return {"emb": emb, "blocks": tuple(per_pos),
            "final_ln": L.init_rmsnorm(cfg.d_model, device)}


# ---------------------------------------------------------------------------
# the depth loop


def _run_stack(blocks, cfg: ModelConfig, pattern, x: torch.Tensor, *,
               causal: bool = True, enc_out=None, cache_len: int = 0,
               impl: str = "auto"):
    """Depth loop over the superblocks.  With ``cache_len > 0`` it also
    returns every block's decode cache (prefill handoff), stacked over
    superblocks -- the ``init_cache`` layout."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [[] for _ in pattern]
    for i in range(cfg.num_superblocks):
        for pos, kind in enumerate(pattern):
            x, a, c = B.apply_block(_at(blocks[pos], i), cfg, kind, x,
                                    causal=causal, enc_out=enc_out,
                                    cache_len=cache_len, impl=impl)
            aux = aux + a
            caches[pos].append(c)
    if cache_len:
        return x, aux, tuple(_stack(c) for c in caches)
    return x, aux


def _decoder_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Embed the text tokens (the vision prefix waits for item 16)."""
    if cfg.modality == "vision":
        raise NotImplementedError(f"the vision prefix waits for {L.ZOO_ITEM}")
    return L.embed(params["emb"], cfg, batch["tokens"])


def _check_decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models wait for "
                                  f"{L.ZOO_ITEM}")


# ---------------------------------------------------------------------------
# serving forward


@torch.inference_mode()
def forward_hidden(params, cfg: ModelConfig, batch: Dict, *,
                   impl: str = "auto") -> torch.Tensor:
    """Prefill: final hidden states [B,S,D] (no loss).  ``impl`` forces the
    attention core's route (``ops.flash_attention``)."""
    _check_decoder_only(cfg)
    x = _decoder_inputs(params, cfg, batch)
    x, _ = _run_stack(params["blocks"], cfg, cfg.block_pattern, x,
                      causal=True, impl=impl)
    return L.rmsnorm(params["final_ln"], x, cfg.norm_eps)


@torch.inference_mode()
def prefill_with_cache(params, cfg: ModelConfig, batch: Dict,
                       cache_len: int, *, impl: str = "auto"
                       ) -> Tuple[torch.Tensor, PyTree]:
    """Serving prefill that also writes the decode cache: returns
    (hidden [B,S,D], cache) where the cache matches ``init_cache(cfg, B,
    cache_len)`` and decode continues at pos = S."""
    _check_decoder_only(cfg)
    x = _decoder_inputs(params, cfg, batch)
    x, _, cache = _run_stack(params["blocks"], cfg, cfg.block_pattern, x,
                             causal=True, cache_len=cache_len, impl=impl)
    return L.rmsnorm(params["final_ln"], x, cfg.norm_eps), cache


# ---------------------------------------------------------------------------
# decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cpu") -> PyTree:
    """Stacked decode cache: a tuple (per pattern position) of dicts whose
    tensors have leading axis num_superblocks (zeros, allocated: decode
    writes into them in place)."""
    caches = []
    for kind in cfg.block_pattern:
        one = B.init_block_cache(cfg, kind, batch, max_len, device)
        caches.append({k: v.expand((cfg.num_superblocks,) + v.shape).clone()
                       for k, v in one.items()})
    return tuple(caches)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos,
                *, enc_out=None) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  tokens: [B,1] int; pos: the current position (an
    int or a 0-d tensor).  Returns (logits [B, vocab] fp32, cache), the
    cache being the one given, updated in place at ``pos``'s slot."""
    _check_decoder_only(cfg)
    x = L.embed(params["emb"], cfg, tokens)
    pattern = cfg.block_pattern
    for i in range(cfg.num_superblocks):
        for p_idx, kind in enumerate(pattern):
            x, _ = B.apply_block_decode(_at(params["blocks"][p_idx], i), cfg,
                                        kind, x, _at(cache[p_idx], i), pos,
                                        enc_out=enc_out)
    x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = (x[:, 0, :] @ L.unembed_matrix(params["emb"], cfg)).float()
    return logits, cache


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(param_count(v) for v in params)
    return params.numel()
