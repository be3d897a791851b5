"""pixtral-12b — VLM: pixtral-ViT frontend (STUB: precomputed patch
embeddings) + mistral-nemo decoder backbone [hf:mistralai/Pixtral-12B-2409].
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072,
    head_dim=128, rope_theta=1000000.0,
    modality="vision", modal_embed_dim=1024, num_modal_tokens=1024,
    citation="hf:mistralai/Pixtral-12B-2409",
)
