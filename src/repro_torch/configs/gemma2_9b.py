"""Gemma 2 9B [arXiv:2408.00118]: local+global alternating, softcaps."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab_size=256000, head_dim=256,
    block_pattern=("local", "global"), window_size=4096,
    mlp_type="geglu", attn_softcap=50.0, logit_softcap=30.0,
    post_norm=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=32,
    block_pattern=("local", "global"), window_size=64,
    mlp_type="geglu", attn_softcap=50.0, logit_softcap=30.0,
    post_norm=True, tie_embeddings=True,
)
