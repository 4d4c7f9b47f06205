"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
port of ``repro/models/rglru.py``).

Block structure:
    x -> [gate branch: GeLU(x W_g)]                          (B,S,W)
      -> [rec branch:  x W_in -> causal conv1d(4) -> RG-LRU] (B,S,W)
    out = (gate * rglru) W_out                                (B,S,D)

RG-LRU cell (diagonal gated linear recurrence), in float32:
    r_t = sigmoid(w_a . u_t + b_a)          recurrence gate
    i_t = sigmoid(w_x . u_t + b_x)          input gate
    a_t = exp(-c * softplus(lam) * r_t)     per-channel decay, c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

Prefill runs the recurrence as a log-depth doubling scan over the
sequence (JAX's ``associative_scan``, which is no Pallas kernel: torch
ops here), chunked exactly where JAX chunks it: chunks of 512 with the
boundary state carried between them when ``s % 512 == 0 and s > 512``,
else one scan.  The association order differs from XLA's, so the two
agree to float32 rounding, not bit for bit.  Decode is the exact
single-step update with the carried (conv window, h) state.

Training takes autograd through these ops.  The square root's argument
is bounded with ``torch.clamp`` where JAX writes ``jnp.clip``: they
split the gradient alike off the bounds, and the backward matches
``jax.grad`` to float32 rounding, so the form stays.  On a ``model``
axis the block runs on the rank's channels (``rglru_block``'s ``tp``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

import repro_torch
from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = L.Params
_C = 8.0
CHUNK = 512


@dataclasses.dataclass
class RglruCache(L.StateCache):
    conv: torch.Tensor   # (..., B, conv_width - 1, W) trailing inputs
    h: torch.Tensor      # (..., B, W) recurrent state, float32


def init_rglru(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """The block's weights on the generator's device (JAX's
    ``init_rglru``'s shapes, dtypes and distributions; other draws)."""
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = L.dtype_of(cfg)
    dev = generator.device
    kw = cfg.rglru_conv_width

    def tn(shape, fan_in):
        return L.trunc_normal(generator, shape, dt, fan_in)

    f32 = dict(dtype=torch.float32, device=dev)
    # lambda init so a^c in [0.9, 0.999] (Griffin's stable-decay init)
    u = repro_torch.uniform((w,), 0.9 ** 2, 0.999 ** 2, generator)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    return {
        "w_in": tn((d, w), d),
        "w_gate": tn((d, w), d),
        "w_out": tn((w, d), w),
        "conv_w": tn((kw, w), kw),
        "conv_b": torch.zeros(w, dtype=dt, device=dev),
        "gate_a_w": torch.zeros(w, **f32),
        "gate_a_b": torch.zeros(w, **f32),
        "gate_x_w": torch.zeros(w, **f32),
        "gate_x_b": torch.zeros(w, **f32),
        "lam": lam,
    }


def _causal_conv(p: Params, u: torch.Tensor, prev: Optional[torch.Tensor]):
    """Depthwise causal conv over time.  u: (B, S, W).  Returns the
    output and the new state: the last ``kw - 1`` pre-conv inputs."""
    kw = p["conv_w"].shape[0]
    if prev is None:
        pad = torch.zeros(u.shape[0], kw - 1, u.shape[2], dtype=u.dtype,
                          device=u.device)
    else:
        pad = prev.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                 # (B, S+kw-1, W)
    s = u.shape[1]
    out = full[:, 0:s] * p["conv_w"][0]
    for i in range(1, kw):
        out = out + full[:, i:i + s] * p["conv_w"][i]
    new_prev = full[:, -(kw - 1):] if kw > 1 else pad[:, :0]
    return out + p["conv_b"], new_prev


def _cell_coeffs(p: Params, u: torch.Tensor):
    """Per-step (a_t, b_t) of h_t = a_t h_{t-1} + b_t, float32.
    softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``."""
    uf = u.to(torch.float32)
    r = torch.sigmoid(uf * p["gate_a_w"] + p["gate_a_b"])
    i = torch.sigmoid(uf * p["gate_x_w"] + p["gate_x_b"])
    lam = p["lam"]
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-9, 1.0)
                   ) * (i * uf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t of h_t = a_t h_{t-1} + b_t, h_{-1} = 0, over axis 1 of
    (B, S, W): a doubling scan of ceil(log2 S) steps, each combining
    element t with element t - 2^k as JAX's ``combine`` does, (a1, b1)
    then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        if 2 * off < s:               # the last step needs no new a
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def rglru_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[RglruCache] = None,
                tp: Optional[shd.ModelGroup] = None
                ) -> tuple[torch.Tensor, Optional[RglruCache]]:
    """x: (B, S, D) -> (out (B, S, D), new cache; None without one).

    S > 1 (or no cache): the chunked scan from the cache's h (zeros
    without one).  S == 1 with a cache: the exact recurrent step.

    With ``tp`` (the specs split ``rglru.w_in``) the block runs on this
    rank's channels of the LRU width: ``x`` through ``copy_to_model``
    into the column shards of ``w_gate`` and ``w_in``; the conv, the
    gates and ``lam`` are the rank's slices, and the conv, the cell and
    the scan act per channel, so they need no collective (JAX pins the
    width to ``model`` there, ``rglru.py:112-119``); ``w_out`` is
    row-parallel into ``reduce_from_model``."""
    tp = L.split_over_model("rglru.w_in", tp)
    if tp is not None:
        x = shd.copy_to_model(x, tp)
    b, s, _ = x.shape
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u = x @ p["w_in"]
    u, new_conv = _causal_conv(p, u, cache.conv if cache is not None
                               else None)
    a, bt = _cell_coeffs(p, u)

    if s == 1 and cache is not None:
        h = a[:, 0] * cache.h + bt[:, 0]                  # (B, W)
        hs = h[:, None, :]
    else:
        h = (cache.h if cache is not None else
             torch.zeros(b, a.shape[-1], dtype=torch.float32,
                         device=x.device))
        # assoc-scan inside chunks of 512, the boundary state carried
        # across them, where JAX chunks (s % 512 == 0 and s > 512)
        chunk = CHUNK if s % CHUNK == 0 and s > CHUNK else s
        outs = []
        for c in range(0, s, chunk):
            ac, bc = a[:, c:c + chunk], bt[:, c:c + chunk]
            bc = torch.cat([bc[:, :1] + ac[:, :1] * h[:, None], bc[:, 1:]],
                           dim=1)
            hc = linear_scan(ac, bc)
            h = hc[:, -1]
            outs.append(hc)
        hs = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    new_cache = RglruCache(conv=new_conv, h=h) if cache is not None else None
    out = (hs.to(gate.dtype) * gate) @ p["w_out"]
    if tp is not None:
        out = shd.reduce_from_model(out, tp)
    return out, new_cache


def init_cache(cfg: ModelConfig, batch: int, lead: tuple = (),
               device=None) -> RglruCache:
    """Zero state, stacked over ``lead`` (the pattern groups)."""
    w = cfg.lru_width or cfg.d_model
    return RglruCache(
        conv=torch.zeros(lead + (batch, cfg.rglru_conv_width - 1, w),
                         dtype=L.dtype_of(cfg), device=device),
        h=torch.zeros(lead + (batch, w), dtype=torch.float32,
                      device=device))
