"""jamba-v0.1-52b — Mamba+attention 1:7 hybrid with MoE every 2nd layer
[arXiv:2403.19887].  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_d_ff=14336, moe_every=2,
    attn_period=8,                # 1 attention layer per 8 (1:7 interleave)
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    citation="arXiv:2403.19887",
)
