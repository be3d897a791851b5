"""h2o-danube-1.8b — dense decoder, llama+mistral mix with sliding-window
attention [arXiv:2401.16818].  24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096,          # mistral-style SWA (model card)
    rope_theta=10000.0,
    citation="arXiv:2401.16818",
)
