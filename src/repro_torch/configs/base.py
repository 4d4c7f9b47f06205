"""Model configuration (port of ``repro/configs/base.py``).

Holds the fields every family of the JAX package reads, with the JAX
defaults: the dense families (qwen2, gemma2, chatglm3, nemotron), the
MoE family (qwen2-moe, granite-moe), the recurrent families
(recurrentgemma, xLSTM), and the modality stubs: phi-3-vision's
projected image embeddings and seamless's encoder-decoder stacks with
its projected audio frames; the dry run's shapes (:class:`ShapeConfig`,
:data:`SHAPES`, :func:`runnable_shapes`) as JAX states them.
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
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
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

    # encoder-decoder (seamless): n_layers applies to EACH stack
    encoder_layers: int = 0

    # modality frontend stubs
    frontend: Optional[str] = None  # "vision_stub" | "audio_stub"
    n_frontend_tokens: int = 0
    frontend_dim: int = 0

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
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def n_front(self) -> int:
        """Positions the frontend prepends to the text: the image tokens
        of a vision stub, 0 otherwise (the audio frames feed the
        encoder)."""
        return (self.n_frontend_tokens if self.frontend == "vision_stub"
                else 0)

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

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), JAX's
        formula: an encoder-decoder counts its blocks twice (the
        cross-attention taken as the size of an attention), a frontend
        adds its projection."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qo = d * (self.n_heads * hd) * 2
        kv = d * (self.n_kv_heads * hd) * 2
        mlp_mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        per_kind = {}
        for kind in set(self.block_pattern):
            if kind in ("global", "local"):
                per_kind[kind] = qo + kv + mlp_mult * d * dff
            elif kind == "rglru":
                w = self.lru_width or d
                per_kind[kind] = 2 * d * w + w * d + 3 * w + mlp_mult * d * dff
            elif kind == "mlstm":
                per_kind[kind] = qo + kv + 2 * d * (2 * d)
            elif kind == "slstm":
                per_kind[kind] = 4 * d * d + 4 * d * d // 4 + 2 * d * (2 * d)
            elif kind == "moe":
                m = self.moe
                e_params = (m.n_experts + m.n_shared) * 3 * d * m.d_expert
                per_kind[kind] = qo + kv + e_params + d * m.n_experts
        n_groups, tail = self.pattern_layout()
        blocks = n_groups * sum(per_kind[k] for k in self.block_pattern)
        blocks += sum(per_kind[k] for k in tail)
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            blocks *= 2   # encoder + decoder stacks (cross-attn ~ attn)
        if self.frontend:
            emb += self.frontend_dim * d
        return blocks + emb

    def active_param_count(self) -> int:
        """Parameters touched a token (MoE: only the routed top-k and the
        shared experts), JAX's formula."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        all_e = (m.n_experts + m.n_shared) * 3 * d * m.d_expert
        act_e = (m.top_k + m.n_shared) * 3 * d * m.d_expert
        return self.param_count() - self.n_layers * (all_e - act_e)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def runnable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The shapes of :data:`SHAPES` this architecture runs: all but
    ``long_500k``, which only a model with no full-sequence attention
    takes."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        out.append("long_500k")
    return tuple(out)
