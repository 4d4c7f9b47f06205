"""Model configuration (port of ``repro/configs/base.py``).

Holds the fields the dense global-attention path reads.  The MoE,
recurrent, enc-dec and frontend fields of the JAX ``ModelConfig``
arrive with the slices that port those families.
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

    block_pattern: Tuple[str, ...] = ("global",)

    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    mlp_type: str = "swiglu"

    norm_eps: float = 1e-6
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
