"""Architecture registry and reduced (smoke) variants: the port of
``repro/configs/registry.py``'s ``ARCH_IDS``, ``get_config``,
``all_configs``, ``reduce_config`` and ``applicable``.

``get_config(arch_id)`` returns the exact assigned configuration;
``reduce_config(cfg)`` produces the family-preserving smoke variant
(<=2 layers, d_model<=512, <=4 experts); ``input_specs`` gives a model's
inputs for one (arch, input shape) pair as ``TensorSpec``s (shape and
dtype, nothing allocated) and ``make_dummy_inputs`` small concrete ones
(``launch.train.make_batch_from_specs`` turns them into a loss-ready
batch).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device

ARCH_IDS = (
    "h2o-danube-1.8b", "jamba-v0.1-52b", "qwen2-7b", "xlstm-1.3b",
    "olmoe-1b-7b", "granite-moe-1b-a400m", "phi3-mini-3.8b", "pixtral-12b",
    "seamless-m4t-medium", "llama3-405b",
)

_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-7b": "qwen2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama3-405b": "llama3_405b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduce_config(cfg: ModelConfig, *, seq_len: int = 64) -> ModelConfig:
    """Family-preserving reduced variant for CPU smoke tests."""
    changes = dict(
        name=cfg.name + "-smoke",
        d_model=256, num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=None,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=(min(cfg.sliding_window, seq_len // 2)
                        if cfg.sliding_window else None),
        mlstm_chunk=16,
        attn_q_chunk=32, loss_seq_chunk=32,
        num_modal_tokens=8, modal_embed_dim=32,
        mamba_dt_rank=None,
    )
    if cfg.is_moe:
        changes.update(num_experts=4, experts_per_token=2, moe_d_ff=128)
    if cfg.is_hybrid:
        changes.update(attn_period=2, num_layers=4, moe_every=2)
    elif cfg.is_xlstm:
        changes.update(slstm_every=2, num_layers=4)
    else:
        changes.update(num_layers=2)
    if cfg.is_encoder_decoder:
        changes.update(num_encoder_layers=2)
    return dataclasses.replace(cfg, **changes)


def applicable(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None if this (arch x shape) pair runs; else a skip reason."""
    if shape.name == "long_500k":
        subquadratic = (cfg.is_hybrid or cfg.is_xlstm
                        or cfg.sliding_window is not None)
        if not subquadratic:
            return "full attention, no sub-quadratic variant (DESIGN.md §4)"
    return None


# ---------------------------------------------------------------------------
# input specs (shape and dtype stand-ins, no allocation)


class TensorSpec(NamedTuple):
    """The reference's ``jax.ShapeDtypeStruct``: a tensor's shape and
    dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _enc_len(seq_len: int) -> int:
    return max(seq_len // 4, 8)


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                dtype: torch.dtype = torch.int32) -> Dict[str, TensorSpec]:
    """Model inputs for one (arch, input-shape) pair.

    train/prefill: the token batch (a vision model's text is S minus its
    image tokens), labels for train, and the stub modality embeddings.
    decode: one new token a sequence and the position (the cache is built
    apart, by the launcher)."""
    from repro_torch.models.layers import dtype_of
    b, s = shape.global_batch, shape.seq_len
    emb_dt = dtype_of(cfg)
    specs: Dict[str, TensorSpec] = {}
    if shape.kind in ("train", "prefill"):
        s_text = s - cfg.num_modal_tokens if cfg.modality == "vision" else s
        specs["tokens"] = TensorSpec((b, s_text), dtype)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, s_text), dtype)
        if cfg.modality == "vision":
            specs["modal_embeds"] = TensorSpec(
                (b, cfg.num_modal_tokens, cfg.modal_embed_dim), emb_dt)
        if cfg.is_encoder_decoder:
            specs["src_embeds"] = TensorSpec(
                (b, _enc_len(s), cfg.modal_embed_dim), emb_dt)
    else:
        specs["tokens"] = TensorSpec((b, 1), dtype)
        specs["pos"] = TensorSpec((), dtype)
        if cfg.is_encoder_decoder:
            specs["src_embeds"] = TensorSpec(
                (b, _enc_len(min(s, 4096)), cfg.modal_embed_dim), emb_dt)
    return specs


def make_dummy_inputs(cfg: ModelConfig, shape: InputShape,
                      gen: Optional[torch.Generator] = None,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete small inputs matching ``input_specs`` (smoke tests only):
    token ids uniform over the vocabulary, ``pos`` 0, embeddings N(0, 1),
    drawn from the CPU generator ``gen`` (seed 0 by default) in the specs'
    order, then moved to ``device``."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype.is_floating_point:
            t = torch.randn(spec.shape, generator=gen).to(spec.dtype)
        elif name == "pos":
            t = torch.zeros(spec.shape, dtype=spec.dtype)
        else:
            t = torch.randint(0, cfg.vocab_size, spec.shape,
                              generator=gen).to(spec.dtype)
        out[name] = t.to(dev)
    return out
