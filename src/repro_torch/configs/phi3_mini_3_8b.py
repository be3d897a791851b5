"""phi3-mini-3.8b — dense decoder, RoPE + SwiGLU + GQA [arXiv:2404.14219].
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    citation="arXiv:2404.14219",
)
