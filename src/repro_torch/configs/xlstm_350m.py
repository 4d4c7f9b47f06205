"""xLSTM 350M [arXiv:2405.04517]: mLSTM / sLSTM blocks, 3:1.

d_ff = 0: no separate FFN (the xLSTM blocks carry their own up/down
projections).  No attention, so no KV cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlp_type="none", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="ssm",
    n_layers=4, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=512,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlp_type="none", tie_embeddings=True,
)
