"""ChatGLM3 6B [arXiv:2406.12793]: 2d (partial) RoPE, GQA kv=2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    block_pattern=("global",), rope_fraction=0.5, qkv_bias=True,
    mlp_type="swiglu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=384, vocab_size=512,
    block_pattern=("global",), rope_fraction=0.5, qkv_bias=True,
    mlp_type="swiglu", tie_embeddings=False,
)
