"""SeamlessM4T medium [arXiv:2308.11596]: encoder-decoder, multimodal.

"12L" = 12 encoder + 12 decoder layers (released medium config).  The
audio frontend (conformer feature extractor) is a STUB: the caller
supplies precomputed frame embeddings (B, S_frames, 1024), fed to the
encoder; the decoder is a causal stack with cross-attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    block_pattern=("global",), mlp_type="swiglu",
    encoder_layers=12,
    frontend="audio_stub", frontend_dim=1024,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    block_pattern=("global",), mlp_type="swiglu",
    encoder_layers=2,
    frontend="audio_stub", frontend_dim=64,
    tie_embeddings=True,
)
