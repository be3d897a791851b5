"""seamless-m4t-medium — encoder-decoder, audio frontend STUB (precomputed
frame embeddings) [arXiv:2308.11596].  12L (x2: enc+dec) d_model=1024 16H
(kv=16) d_ff=4096 vocab=256206."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    num_encoder_layers=12,
    modality="audio", modal_embed_dim=1024, num_modal_tokens=1024,
    citation="arXiv:2308.11596",
)
