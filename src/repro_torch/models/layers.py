"""Model layers for the dense families (port of
``repro/models/layers.py``): GQA with QKV bias, global and local
(sliding-window) attention with the attention softcap, the ring KV cache
of local layers, partial rotary (chatglm), SwiGLU / GeGLU / squared-ReLU
MLPs, tied or untied unembedding with the logit softcap.

Plain functions on tensors.  Weights keep the JAX layout (``x @ w``,
``w`` of shape (in, out)), so weights carried across from the JAX
package are used as they are.  The dtypes follow the JAX code step by
step: rmsnorm and the attention logits in float32, the rotary tables in
float32 (so rotated q and k are float32, as in JAX), the rest in the
config's dtype.

A prompt with ``s * s_kv > FLASH_THRESHOLD`` takes the tiled
online-softmax path (:func:`tiled_attention`, the JAX package's
``_flash_attention``, local masks and softcap included), which never
builds the ``(s, s_kv)`` logits.  :func:`attention` also runs the
encoder's bidirectional self-attention (``causal=False``: rotary, no
mask) and cross-attention (``memory``: k/v projected from the encoder's
output, no rotary, no mask, no cache), on the dense or the tiled path
as the JAX package chooses.

Tensor parallelism (Megatron, as the JAX package's partition specs and
``_head_shard``/``_proj_shard`` constraints have GSPMD lay it out):
given a :class:`repro_torch.sharding.ModelGroup`, :func:`attention`
(self- and cross-attention, causal or not) and :func:`mlp` run
column-parallel in-projections on their input (and on the encoder's
``memory``) through ``copy_to_model`` and a row-parallel ``wo`` into
``reduce_from_model``; :func:`embed` and :func:`unembed` split the
vocabulary.  Each takes its leaves' local shards.  Without one they run
as on one device; the model passes one only to a block whose leaves the
partition specs split (:func:`split_over_model`, reading
``ModelGroup.split`` from ``convert.model_group``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

import repro_torch
from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]

FLASH_THRESHOLD = 4 * 1024 * 1024   # s_q * s_kv above which attention tiles


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def trunc_normal(generator: torch.Generator, shape, dtype,
                 fan_in: int) -> torch.Tensor:
    """Truncated normal in [-2, 2] std, std = 1/sqrt(fan_in), drawn in
    float32 on the generator's device and rounded to ``dtype``, as in
    JAX.  Empty from a meta generator."""
    if isinstance(generator, repro_torch.MetaGenerator):
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * fan_in ** -0.5).to(dtype)


def split_over_model(name: str, tp: Optional[shd.ModelGroup]
                     ) -> Optional[shd.ModelGroup]:
    """``tp`` when the specs split leaf ``name`` (a short name,
    ``convert.short_names``) over ``model``, else None (a leaf the
    divisibility guard keeps whole)."""
    return tp if tp is not None and name in tp.split else None


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale)).to(dt)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                fraction: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., S, rot_dim/2), float32, over the rotary
    sub-dimension rot_dim = head_dim * fraction rounded down to even
    (chatglm's partial rotary: fraction 0.5)."""
    rot_dim = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    freq = 1.0 / torch.pow(theta, exps)
    angles = positions[..., None].to(torch.float32) * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); rotates interleaved pairs (0, 1), (2, 3), ... of
    the first rot_dim = 2 * cos.shape[-1] dims, the rest passes through
    (cast to the rotated part's float32, as JAX's concatenate does)."""
    rot_dim = 2 * cos.shape[-1]
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = rot[..., 0::2], rot[..., 1::2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    y = torch.stack([y1, y2], dim=-1).reshape(rot.shape)
    if not rest.shape[-1]:
        return y
    return torch.cat([y, rest.to(y.dtype)], dim=-1)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


class StateCache:
    """What every cache node of the model shares (a dataclass of tensors,
    one layer's or a stack of layers' with a leading layer axis):
    :meth:`layer` gives layer ``i``'s views of a stack, :meth:`clone` a
    copy, :meth:`store` writes another node's values into this one in
    place."""

    def tensors(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def layer(self, i: int):
        return type(self)(*(t[i] for t in self.tensors()))

    def clone(self):
        return type(self)(*(t.clone() for t in self.tensors()))

    def store(self, new) -> None:
        for t, n in zip(self.tensors(), new.tensors()):
            t.copy_(n)


@dataclasses.dataclass
class AttnCache(StateCache):
    """Decode-time KV cache of one attention layer, or of a stack of
    layers (``k``/``v`` (n, B, S, KV, Dh), ``pos`` (n, S), as the JAX
    model stacks the caches of its scanned layers; :meth:`layer` gives
    one layer's views).

    ``pos`` holds each slot's true position, -1 while empty.  A local
    layer's cache is a ring of ``min(window_size, s_max)`` slots: the
    token at position ``i`` sits in slot ``i % S``, so masks and rotary
    stay exact after it wraps.  Prefill and decode write into the views
    in place (the JAX decode donates its caches); copy a cache that must
    outlive a decode.
    """
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def _kv_weights(p: Params, cfg: ModelConfig,
                tp: Optional[shd.ModelGroup], leaf: str = "attn.wk"):
    """wk, wv (and bk, bv) as this rank's k/v projection uses them (``leaf``
    names the wk whose split decides: ``attn.wk``, or ``xattn.wk`` for the
    cross-attention).  The JAX package's ``_proj_shard`` splits the kv
    heads over ``model`` only when ``tp`` divides their count; else GQA's
    few kv heads stay whole on every rank:

    - (a) ``n_kv % tp == 0``: the local shards are this rank's kv heads;
    - (b) the spec splits wk/wv in storage but not by heads: all-gather
      the weights (``gather_from_model``), so each rank's gradient is the
      reduce-scatter of every rank's partial one;
    - (c) the guard kept them whole: every rank holds them, and their
      gradient is summed over ``model`` (``copy_to_model``).
    """
    names = ("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv")
    w = [p[n] for n in names]
    if _own_kv(cfg, tp):
        return w
    if split_over_model(leaf, tp) is not None:
        return [shd.gather_from_model(t, tp) for t in w]
    return [shd.copy_to_model(t, tp) for t in w]


def _own_kv(cfg: ModelConfig, tp: Optional[shd.ModelGroup]) -> bool:
    """Whether each rank holds its own kv heads (or there is no ``tp``)."""
    return tp is None or cfg.n_kv_heads % tp.size == 0


def _kv_of_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                 tp: Optional[shd.ModelGroup], h_local: int):
    """Where the kv heads stay whole on every rank, the kv head of each
    of this rank's ``h_local`` q heads (head j uses kv head j // (H /
    n_kv), as unsharded GQA does), so the grouping is one q head a kv
    head; else k and v as they are."""
    if _own_kv(cfg, tp):
        return k, v
    heads = (tp.index * h_local + torch.arange(h_local, device=k.device)
             ) // (cfg.n_heads_padded // cfg.n_kv_heads)
    return k[:, :, heads], v[:, :, heads]


def _heads(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           hd: int) -> torch.Tensor:
    """``x @ w`` (+ ``b``), split into heads of ``hd``: (B, S, -1, hd)."""
    y = x @ w
    if b is not None:
        y = y + b
    return y.reshape(*x.shape[:2], -1, hd)


def _q_input(cfg: ModelConfig, x: torch.Tensor,
             tp: Optional[shd.ModelGroup]) -> torch.Tensor:
    """``x`` as a column-parallel q projection takes it: through
    ``copy_to_model`` with ``tp``, whose size must divide the heads."""
    if tp is None:
        return x
    if cfg.n_heads_padded % tp.size:
        raise ValueError(f"{cfg.n_heads_padded} heads do not split over "
                         f"{tp.size} model ranks")
    return shd.copy_to_model(x, tp)


def project(p: Params, cfg: ModelConfig, x: torch.Tensor,
            tp: Optional[shd.ModelGroup] = None):
    """The self-attention projections with optional bias, split into
    heads and not rotated: q (B, S, H, Dh), k and v (B, S, KV, Dh), in
    the compute dtype.

    With ``tp`` (wq/bq split by heads) H is this rank's H / tp heads and
    KV its own kv heads, or all of them where the kv heads stay whole:
    the layout a rank's KV cache stores.  :func:`_kv_of_heads` maps them
    to the rank's q heads after the cache."""
    hd = cfg.resolved_head_dim
    x = _q_input(cfg, x, tp)
    wk, wv, *bkv = _kv_weights(p, cfg, tp)
    bias = cfg.qkv_bias
    q = _heads(x, p["wq"], p["bq"] if bias else None, hd)
    k = _heads(x, wk, bkv[0] if bias else None, hd)
    v = _heads(x, wv, bkv[1] if bias else None, hd)
    return q, k, v


def cross_kv(p: Params, cfg: ModelConfig, memory: torch.Tensor,
             tp: Optional[shd.ModelGroup] = None):
    """Cross-attention's k and v (B, S_enc, KV, Dh) from the encoder's
    output ``memory`` (B, S_enc, D): projected with optional bias, no
    rotary.  The JAX model keeps no cross cache, so a decode step
    computes them anew, as here.  With ``tp`` (``xattn.wq`` split):
    ``memory`` through ``copy_to_model``, KV this rank's kv heads, or all
    of them where they stay whole (:func:`_kv_weights` on
    ``xattn.wk``)."""
    hd = cfg.resolved_head_dim
    bias = cfg.qkv_bias
    if tp is not None:
        memory = shd.copy_to_model(memory, tp)
    wk, wv, *b = _kv_weights(p, cfg, tp, "xattn.wk")
    return (_heads(memory, wk, b[0] if bias else None, hd),
            _heads(memory, wv, b[1] if bias else None, hd))


def qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
        positions: torch.Tensor, tp: Optional[shd.ModelGroup] = None):
    """:func:`project`, then rotary at ``positions``: q (B, S, H, Dh)
    and k (B, S, KV, Dh) rotated, in float32 (the JAX code's float32
    tables make them so), v (B, S, KV, Dh) in the compute dtype."""
    q, k, v = project(p, cfg, x, tp)
    cos, sin = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.rope_fraction)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def dense_attention(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Grouped-GQA attention against the unrepeated kv: float32 logits
    (B, H, S, S_kv), softcapped after the scale, under ``mask`` (None:
    every key), the softmax rounded to v's dtype.  Returns (B, S, H, Dh)
    in v's dtype."""
    b, s, h, hd = q.shape
    kv, s_kv = kq.shape[2], kq.shape[1]
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.to(torch.float32),
                          kq.to(torch.float32)) * hd ** -0.5
    logits = _softcap(logits.reshape(b, h, s, s_kv), softcap)
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    attn = torch.softmax(logits, dim=-1).to(vq.dtype)
    attn_g = attn.reshape(b, kv, rep, s, s_kv)
    out = torch.einsum("bkrqs,bskd->bqkrd", attn_g, vq)
    return out.reshape(b, s, h, hd)


def tiled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    qpos: torch.Tensor, kpos: torch.Tensor,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None, causal: bool = True,
                    q_blk: int = 1024, kv_blk: int = 1024) -> torch.Tensor:
    """Attention in tiles with an online softmax (the JAX package's
    ``_flash_attention``).

    q: (B, Sq, H, D); k, v: (B, Skv, H, D), already repeated to q's heads;
    ``qpos`` (Sq,) and ``kpos`` (Skv,) the true positions.  Per q tile,
    a loop over kv tiles carries the running max, the normalizer and the
    output in float32; logits are float32 (softcapped after the scale),
    the probabilities are rounded to v's dtype before the product, which
    accumulates in float32, as JAX's ``preferred_element_type`` does.
    The mask: ``kp >= 0``; with ``causal`` ``kp <= qp``; with ``window``
    (a local layer) ``kp > qp - window``; masked logits are -1e30.  Every tile is
    visited, as in JAX.  Never builds more than one (B, H, q_blk, kv_blk)
    tile.  Returns (B, Sq, H, D) float32.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q_blk = min(q_blk, sq)
    kv_blk = min(kv_blk, skv)
    assert sq % q_blk == 0 and skv % kv_blk == 0, (sq, q_blk, skv, kv_blk)
    scale = d ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty(b, sq, h, d, **f32)
    for i in range(0, sq, q_blk):
        qt = q[:, i:i + q_blk].to(torch.float32)
        qp = qpos[i:i + q_blk]
        m = torch.full((b, h, q_blk), -1e30, **f32)
        l = torch.zeros((b, h, q_blk), **f32)
        acc = torch.zeros((b, h, q_blk, d), **f32)
        for j in range(0, skv, kv_blk):
            kt = k[:, j:j + kv_blk].to(torch.float32)
            vt = v[:, j:j + kv_blk]
            kp = kpos[j:j + kv_blk]
            logits = _softcap(torch.einsum("bqhd,bkhd->bhqk", qt, kt)
                              * scale, softcap)
            kp4, qp4 = kp[None, None, None, :], qp[None, None, :, None]
            mask = kp4 >= 0
            if causal:
                mask = mask & (kp4 <= qp4)
            if window is not None:
                mask = mask & (kp4 > qp4 - window)
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            p_ = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p_.to(vt.dtype).to(torch.float32),
                vt.to(torch.float32))
            m = m_new
        out[:, i:i + q_blk] = (acc / torch.clamp(l, min=1e-30)[..., None]
                               ).transpose(1, 2)
    return out


def cache_prefill(cache: AttnCache, k: torch.Tensor, v: torch.Tensor
                  ) -> None:
    """Write a length-L prompt's K/V (B, L, KV, Dh) into one layer's
    cache in place (JAX ``_cache_prefill``).  A prompt longer than the
    cache's S slots (a local layer's ring) keeps its last S tokens, the
    token at position i in slot i % S."""
    l, sc = k.shape[1], cache.k.shape[1]
    if l <= sc:
        cache.k[:, :l] = k.to(cache.k.dtype)
        cache.v[:, :l] = v.to(cache.v.dtype)
        cache.pos[:l] = torch.arange(l, device=k.device)
        return
    kept = torch.arange(l - sc, l, device=k.device)
    slots = kept % sc
    cache.k[:, slots] = k[:, -sc:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, -sc:].to(cache.v.dtype)
    cache.pos[slots] = kept.to(cache.pos.dtype)


def cache_decode(cache: AttnCache, k: torch.Tensor, v: torch.Tensor,
                 index: int) -> None:
    """Write one token's K/V (B, 1, KV, Dh) at true position ``index``
    into slot ``index % S`` in place (JAX ``_cache_decode``)."""
    slot = index % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    cache.pos[slot] = index


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              kind: str = "global",
              positions: torch.Tensor,
              causal: bool = True,
              cache: Optional[AttnCache] = None,
              cache_index: Optional[int] = None,
              memory: Optional[torch.Tensor] = None,
              tp: Optional[shd.ModelGroup] = None) -> torch.Tensor:
    """GQA attention with optional QKV bias, padded heads and the
    attention softcap; ``kind="local"`` masks keys at or beyond
    ``window_size`` positions back.

    - train/prefill: (B, S, D) in; with ``cache``, K/V are written to it
      (:func:`cache_prefill`).  Above ``FLASH_THRESHOLD`` (``s * s_kv``)
      it tiles.  ``causal=False`` (the encoder) drops the causal mask.
    - decode: S == 1 with ``cache`` and ``cache_index``: K/V written at
      slot ``cache_index % S``, attention over every filled slot by its
      true position.
    - cross-attention: ``memory`` (B, S_enc, D) gives k and v
      (:func:`cross_kv`); q is not rotated, no key is masked, and it
      tiles above the threshold as self-attention does (JAX
      ``layers.py:355-363``).  No cache: JAX keeps no cross cache.
    - ``tp``: this rank's heads (:func:`project`; in a
      cross-attention its q heads and :func:`cross_kv`'s k and v), its
      rows of ``wo``, and the partial outputs summed over ``model``.  The
      cache holds what :func:`project` gives, the rank's kv heads or all
      of them (``model.init_caches(tp=)``); each q head's kv head is
      picked after the cache is written and read (:func:`_kv_of_heads`).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    window = cfg.window_size if kind == "local" else None
    if memory is not None:
        q = _heads(_q_input(cfg, x, tp), p["wq"],
                   p["bq"] if cfg.qkv_bias else None, hd)
        k, v = _kv_of_heads(*cross_kv(p, cfg, memory, tp), cfg, tp,
                            q.shape[2])
        causal = False
    else:
        q, k, v = qkv(p, cfg, x, positions, tp)
    h = q.shape[2]

    decode = cache is not None and s == 1 and cache_index is not None
    if decode:
        cache_decode(cache, k, v, cache_index)
        k, v = cache.k, cache.v
    elif cache is not None:
        if window is None and s > cache.k.shape[1]:
            raise ValueError(f"prompt of {s} tokens does not fit a "
                             f"{cache.k.shape[1]}-slot cache")
        cache_prefill(cache, k, v)
    if memory is None:
        k, v = _kv_of_heads(k, v, cfg, tp, h)
    kq, vq = k, v
    kv, s_kv = kq.shape[2], kq.shape[1]

    if not decode and s * s_kv > FLASH_THRESHOLD:
        # the tiled path takes kv repeated to the q heads, as JAX does
        rep = h // kv
        out = tiled_attention(
            q, kq.repeat_interleave(rep, dim=2),
            vq.repeat_interleave(rep, dim=2),
            qpos=positions[0] if positions.dim() == 2 else positions,
            kpos=torch.arange(s_kv, device=x.device),
            softcap=cfg.attn_softcap, window=window, causal=causal)
        return _out_proj(out.reshape(b, s, h * hd).to(x.dtype), p["wo"], tp)

    if decode:
        kpos = cache.pos[None, None, None, :]
        mask = (kpos >= 0) & (kpos <= cache_index)
        if window is not None:
            mask = mask & (kpos > cache_index - window)
    else:
        qpos = positions[:, None, :, None]
        kpos = torch.arange(s_kv, device=x.device)[None, None, None, :]
        mask = kpos <= qpos if causal else None
        if window is not None:
            local = kpos > qpos - window
            mask = local if mask is None else mask & local
    out = dense_attention(q, kq, vq, mask, cfg.attn_softcap)
    return _out_proj(out.reshape(b, s, h * hd), p["wo"], tp)


def _out_proj(x: torch.Tensor, wo: torch.Tensor,
              tp: Optional[shd.ModelGroup]) -> torch.Tensor:
    """``x @ wo``; row-parallel with ``tp``: the partial products of the
    ranks' rows summed over ``model``."""
    y = x @ wo
    return y if tp is None else shd.reduce_from_model(y, tp)


def mlp(p: Params, cfg: ModelConfig, x: torch.Tensor,
        tp: Optional[shd.ModelGroup] = None) -> torch.Tensor:
    """SwiGLU, GeGLU (tanh GELU) or squared ReLU (``cfg.mlp_type``); with
    ``tp`` wi/wg are column shards and wo the matching row shard."""
    if tp is not None:
        x = shd.copy_to_model(x, tp)
    if cfg.mlp_type == "swiglu":
        hidden = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.mlp_type == "geglu":
        hidden = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])
    elif cfg.mlp_type == "sqrelu":
        hidden = torch.square(F.relu(x @ p["wi"]))
    else:
        raise ValueError(cfg.mlp_type)
    return _out_proj(hidden, p["wo"], tp)


def embed(table: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor,
          tp: Optional[shd.ModelGroup] = None) -> torch.Tensor:
    """Lookup, then the sqrt(d_model) scale.  With ``tp`` the table is
    this rank's rows of the vocabulary: tokens outside them look up 0,
    and the ranks' lookups are summed over ``model``, which is exact (a
    sum with zeros), so it equals the whole table's lookup bit for bit."""
    if tp is None:
        x = table[tokens]
    else:
        rows = table.shape[0]
        local = tokens - tp.index * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], table[torch.where(mine, local, 0)],
                        0)
        x = shd.reduce_from_model(x, tp)
    # the sqrt(d_model) scale is rounded to the compute dtype, as in JAX
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def unembed(p: Params, cfg: ModelConfig, x: torch.Tensor,
            tp: Optional[shd.ModelGroup] = None) -> torch.Tensor:
    """Logits in the compute dtype from the embedding's leaves ``p``
    (``table``, and ``unembed`` (d, V) when untied): ``x @ table.T`` or
    ``x @ unembed``, then the logit softcap on float32, rounded back.
    With ``tp`` the logits of this rank's rows of the vocabulary (split
    over ``model``, as the JAX package constrains them)."""
    if tp is not None:
        x = shd.copy_to_model(x, tp)
    logits = x @ p["table"].T if cfg.tie_embeddings else x @ p["unembed"]
    if cfg.logit_softcap is not None:
        logits = _softcap(logits.to(torch.float32),
                          cfg.logit_softcap).to(x.dtype)
    return logits
