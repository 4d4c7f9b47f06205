"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini text backbone; the CLIP ViT frontend is a STUB: the caller
supplies precomputed patch embeddings (B, 144, 1024), which a linear
projector maps into d_model and prepends to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    block_pattern=("global",), mlp_type="swiglu",
    frontend="vision_stub", n_frontend_tokens=144, frontend_dim=1024,
    rope_theta=10_000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    block_pattern=("global",), mlp_type="swiglu",
    frontend="vision_stub", n_frontend_tokens=16, frontend_dim=64,
    tie_embeddings=False,
)
