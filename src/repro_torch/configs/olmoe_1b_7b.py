"""olmoe-1b-7b — MoE decoder, 64 experts top-8 [arXiv:2409.02060].
16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    num_experts=64, experts_per_token=8, moe_d_ff=1024, moe_every=1,
    citation="arXiv:2409.02060",
)
