"""Model configuration (port of ``repro/configs/base.py``).

Holds the fields the dense families (qwen2, gemma2, chatglm3, nemotron),
the MoE family (qwen2-moe, granite-moe) and the recurrent families
(recurrentgemma, xLSTM) read, with the JAX defaults.  The enc-dec and
frontend fields of the JAX ``ModelConfig`` arrive with the slice that
ports those families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                  # routed experts
    top_k: int
    d_expert: int                   # per-expert FFN hidden dim
    n_shared: int = 0               # always-on shared experts
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3   # router z-loss
    aux_weight: float = 1e-2        # load-balance aux loss


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm (ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # layer pattern, cycled to n_layers:
    #   "global" | "local" | "rglru" | "mlstm" | "slstm" | "moe"
    block_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096         # local-attention window

    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # chatglm partial rotary = 0.5

    mlp_type: str = "swiglu"        # swiglu | geglu | sqrelu

    moe: Optional[MoEConfig] = None

    norm_eps: float = 1e-6
    post_norm: bool = False         # gemma2: extra post-block norms
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # recurrent blocks
    rglru_conv_width: int = 4
    lru_width: Optional[int] = None

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

    @property
    def is_subquadratic(self) -> bool:
        """True when no block needs full-sequence quadratic attention."""
        return all(k in ("rglru", "mlstm", "slstm", "local")
                   for k in self.block_pattern)

    def pattern_layout(self) -> Tuple[int, Tuple[str, ...]]:
        """(n_groups, tail_kinds): n_layers = n_groups*len(pattern)+tail."""
        plen = len(self.block_pattern)
        return (self.n_layers // plen,
                self.block_pattern[: self.n_layers % plen])
