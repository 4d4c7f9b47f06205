"""RecurrentGemma 9B (Griffin) [arXiv:2402.19427]: RG-LRU + local attn 1:2.

38 layers: pattern (rglru, rglru, local) x12 + tail (rglru, rglru).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"), window_size=2048,
    mlp_type="geglu", lru_width=4096, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
    d_ff=384, vocab_size=512, head_dim=32,
    block_pattern=("rglru", "rglru", "local"), window_size=64,
    mlp_type="geglu", lru_width=128, tie_embeddings=True,
)
