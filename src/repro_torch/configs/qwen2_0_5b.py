"""Qwen2 0.5B [arXiv:2407.10671]: GQA kv=2, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151936,
    block_pattern=("global",), qkv_bias=True,
    rope_theta=1_000_000.0, mlp_type="swiglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=7, n_kv_heads=1,
    d_ff=256, vocab_size=512,
    block_pattern=("global",), qkv_bias=True, mlp_type="swiglu",
)
