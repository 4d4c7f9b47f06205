"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    block_pattern=("moe",), qkv_bias=True, mlp_type="swiglu",
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, n_shared=4),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512,
    block_pattern=("moe",), qkv_bias=True, mlp_type="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=128, n_shared=1),
)
