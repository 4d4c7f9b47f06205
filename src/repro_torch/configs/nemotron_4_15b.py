"""Nemotron-4 15B [arXiv:2402.16819]: GQA kv=8, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    block_pattern=("global",), mlp_type="sqrelu",
    rope_theta=10_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    block_pattern=("global",), mlp_type="sqrelu", tie_embeddings=False,
)
