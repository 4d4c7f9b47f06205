"""Model configuration (port of ``repro/configs/base.py``).

Holds the fields the dense families read (qwen2, gemma2, chatglm3,
nemotron), with the JAX defaults.  The MoE, recurrent, enc-dec and
frontend fields of the JAX ``ModelConfig`` arrive with the slices that
port those families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense (the only family ported yet)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # layer pattern, cycled to n_layers: "global" | "local" (the other
    # kinds of the JAX package are not ported yet)
    block_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096         # local-attention window

    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # chatglm partial rotary = 0.5

    mlp_type: str = "swiglu"        # swiglu | geglu | sqrelu

    norm_eps: float = 1e-6
    post_norm: bool = False         # gemma2: extra post-block norms
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # TP head padding, kept so the parameter shapes (and so the carried
    # JAX weights) match: qwen2's 14 heads become 16, the two extra heads
    # zero-initialised in wq and wo and so inert.
    head_pad_multiple: int = 16

    @property
    def n_heads_padded(self) -> int:
        m = self.head_pad_multiple
        return -(-self.n_heads // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pattern_layout(self) -> Tuple[int, Tuple[str, ...]]:
        """(n_groups, tail_kinds): n_layers = n_groups*len(pattern)+tail."""
        plen = len(self.block_pattern)
        return (self.n_layers // plen,
                self.block_pattern[: self.n_layers % plen])
