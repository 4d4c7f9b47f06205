"""Model layers for the dense global-attention path (port of
``repro/models/layers.py``).

Plain functions on tensors.  Weights keep the JAX layout (``x @ w``,
``w`` of shape (in, out)), so weights carried across from the JAX
package are used as they are.  The dtypes follow the JAX code step by
step: rmsnorm and the attention logits in float32, the rotary tables in
float32 (so rotated q and k are float32, as in JAX), the rest in the
config's dtype.

Local and softcapped attention, cross-attention, the ring cache and the
memory-efficient ``_flash_attention`` arrive with later slices; a prompt
here stays on the dense path (``s * s_kv <= FLASH_THRESHOLD``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]

FLASH_THRESHOLD = 4 * 1024 * 1024   # s_q * s_kv above which JAX tiles


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale)).to(dt)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., S, head_dim/2), float32.  Rotary over the
    whole head; chatglm's partial rotary comes with its family."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freq = 1.0 / torch.pow(theta, exps)
    angles = positions[..., None].to(torch.float32) * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); rotates interleaved pairs (0, 1), (2, 3), ..."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    return torch.stack([y1, y2], dim=-1).reshape(x.shape)


@dataclasses.dataclass
class AttnCache:
    """Decode-time KV cache.

    The model holds one stacked cache for all layers: ``k``/``v``
    (n_layers, B, S, KV, Dh) and ``pos`` (n_layers, S), as the JAX model
    stacks its scanned caches; :meth:`layer` gives one layer's views.
    ``pos`` holds each slot's position, -1 while empty.  Prefill and
    decode write into the views in place (the JAX decode donates its
    caches); copy a cache that must outlive a decode.
    """
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    def layer(self, i: int) -> "AttnCache":
        return AttnCache(k=self.k[i], v=self.v[i], pos=self.pos[i])

    def clone(self) -> "AttnCache":
        return AttnCache(k=self.k.clone(), v=self.v.clone(),
                         pos=self.pos.clone())


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[AttnCache] = None,
              cache_index: Optional[int] = None) -> torch.Tensor:
    """Causal GQA self-attention with optional QKV bias and padded heads.

    - train/prefill: (B, S, D) in; with ``cache``, K/V are written to
      slots [0, S).
    - decode: S == 1 with ``cache`` and ``cache_index``: K/V written at
      slot ``cache_index``, attention over every filled slot.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.resolved_head_dim

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)

    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    decode = cache is not None and s == 1 and cache_index is not None
    if decode:
        cache.k[:, cache_index] = k[:, 0].to(cache.k.dtype)
        cache.v[:, cache_index] = v[:, 0].to(cache.v.dtype)
        cache.pos[cache_index] = cache_index
        kq, vq = cache.k, cache.v
    else:
        if s * s > FLASH_THRESHOLD:
            raise NotImplementedError(
                f"prompt of {s} tokens needs the tiled attention path, "
                "which is not ported yet")
        if cache is not None:
            if s > cache.k.shape[1]:
                raise ValueError(f"prompt of {s} tokens does not fit a "
                                 f"{cache.k.shape[1]}-slot cache")
            cache.k[:, :s] = k.to(cache.k.dtype)
            cache.v[:, :s] = v.to(cache.v.dtype)
            cache.pos[:s] = torch.arange(s, device=x.device)
        kq, vq = k, v
    s_kv = kq.shape[1]

    # grouped-GQA einsums against the unrepeated kv, logits in float32
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.to(torch.float32),
                          kq.to(torch.float32)) * hd ** -0.5
    logits = logits.reshape(b, h, s, s_kv)

    if decode:
        kpos = cache.pos[None, None, None, :]
        mask = (kpos >= 0) & (kpos <= cache_index)
    else:
        qpos = positions[:, None, :, None]
        kpos = torch.arange(s_kv, device=x.device)[None, None, None, :]
        mask = kpos <= qpos
    logits = torch.where(mask, logits, -1e30)

    attn = torch.softmax(logits, dim=-1).to(vq.dtype)
    attn_g = attn.reshape(b, kv, rep, s, s_kv)
    out = torch.einsum("bkrqs,bskd->bqkrd", attn_g, vq)
    return out.reshape(b, s, h * hd) @ p["wo"]


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def embed(table: torch.Tensor, cfg: ModelConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    x = table[tokens]
    # the sqrt(d_model) scale is rounded to the compute dtype, as in JAX
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding; logits in the compute dtype."""
    return x @ table.T
