"""Architecture registry and reduced (smoke) variants: the port of
``repro/configs/registry.py``'s ``ARCH_IDS``, ``get_config``,
``all_configs``, ``reduce_config`` and ``applicable``.

``get_config(arch_id)`` returns the exact assigned configuration;
``reduce_config(cfg)`` produces the family-preserving smoke variant
(<=2 layers, d_model<=512, <=4 experts).  The dry-run's ``input_specs`` and
``make_dummy_inputs`` wait for the port's launchers (ROADMAP queue 1
item 17).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig

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
