"""Granite-3.0 MoE [hf:ibm-granite]: 40 routed experts top-8, d_expert=512."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    block_pattern=("moe",), mlp_type="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, n_shared=0),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    block_pattern=("moe",), mlp_type="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=0),
)
