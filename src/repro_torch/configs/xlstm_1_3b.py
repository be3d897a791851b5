"""xlstm-1.3b — sLSTM + mLSTM block stack [arXiv:2405.04517].
48L d_model=2048 4H d_ff=0 (blocks carry their own projections) vocab=50304.
7:1 mLSTM:sLSTM ratio (xLSTM[7:1])."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=8,                # one sLSTM per 8 blocks (xLSTM[7:1])
    mlstm_chunk=256,
    citation="arXiv:2405.04517",
)
