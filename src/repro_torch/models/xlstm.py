"""xLSTM blocks (arXiv:2405.04517; port of ``repro/models/xlstm.py``):
mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory,
exponential gating, true recurrence).

**mLSTM**: per head, with exponential input gate and stabilizer m:
    C_t = f'_t C_{t-1} + i'_t v_t k_t^T      (d_k x d_v matrix memory)
    n_t = f'_t n_{t-1} + i'_t k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, 1)
Prefill uses the chunkwise-parallel form (quadratic inside chunks of 64,
the state carried between chunks in a Python loop); decode is the exact
sequential step.

**sLSTM**: scalar memory with recurrent gate input R h_{t-1}
(block-diagonal per head), inherently sequential: a Python loop over
time.  Exponential gating stabilized with m_t.

Both carry their own up/down projections (d_ff = 0).  Neither loop is a
Pallas kernel in the JAX package (``lax.scan``): both are torch ops, and
autograd through them is the blocks' backward in training.

The lower bounds are ``torch.clamp`` where JAX writes ``jnp.maximum``
(the mLSTM's denominator, the sLSTM's normalizer).  At an exact tie
``clamp`` passes the whole gradient and ``maximum`` half of it; ties
happen (the sLSTM's ``n_new`` is exactly 1 at t = 0 wherever the input
gate wins), but there the gradient that reaches the bound cancels, so
the backward matches ``jax.grad`` to float32 rounding either way, and
the forms stay as they are.

On a ``model`` axis (``tp``) both blocks run tensor parallel as the JAX
package's specs split their leaves (``mlstm_block``, ``slstm_block``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = L.Params
CHUNK = 64
_F32 = torch.float32


def _tn(generator, shape, fan_in, dtype):
    return L.trunc_normal(generator, shape, dtype, fan_in)


# ======================================================================
# mLSTM
# ======================================================================

@dataclasses.dataclass
class MlstmCache(L.StateCache):
    c: torch.Tensor    # (..., B, H, Dk, Dv) matrix memory
    n: torch.Tensor    # (..., B, H, Dk) normalizer
    m: torch.Tensor    # (..., B, H) stabilizer


def init_mlstm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    di = 2 * d                       # up-projected inner width
    dt = L.dtype_of(cfg)
    hh = cfg.n_heads
    dev = generator.device
    return {
        "w_up": _tn(generator, (d, di), d, dt),
        "w_gate": _tn(generator, (d, di), d, dt),
        "wq": _tn(generator, (di, di), di, dt),
        "wk": _tn(generator, (di, di), di, dt),
        "wv": _tn(generator, (di, di), di, dt),
        "w_if": _tn(generator, (di, 2 * hh), di, _F32),
        "b_if": torch.cat([torch.zeros(hh, device=dev),
                           torch.linspace(3.0, 6.0, hh, device=dev)]),
        "w_down": _tn(generator, (di, d), di, dt),
    }


def _mlstm_seq(q, k, v, logi, logf, c0, n0, m0):
    """Sequential reference / decode step.  q, k, v: (B, S, H, Dk|Dv);
    logi, logf: (B, S, H) float32."""
    c, n, m = c0, n0, m0
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]
        li, lf = logi[:, t], logf[:, t]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)[..., None, None]
        ip = torch.exp(li - m_new)[..., None, None]
        c = fp * c + ip * (kt[..., :, None] * vt[..., None, :])
        n = fp[..., 0] * n + ip[..., 0] * kt
        qf = qt.to(_F32)
        num = torch.einsum("bhkv,bhk->bhv", c, qf)
        den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qf)),
                          min=1.0)
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1), (c, n, m)


def mlstm_parallel(q, k, v, logi, logf, c0, n0, m0):
    """Chunkwise-parallel mLSTM over chunks of ``CHUNK`` (S a multiple of
    it): inside a chunk the stabilized quadratic form, the (C, n, m)
    state carried from chunk to chunk."""
    b, s, h, dk = q.shape
    c, n, m = c0, n0, m0
    mask = (torch.arange(CHUNK, device=q.device)[:, None]
            >= torch.arange(CHUNK, device=q.device)[None, :])
    hs = []
    for j0 in range(0, s, CHUNK):
        sl = slice(j0, j0 + CHUNK)
        qc, kc, vc = (t[:, sl].to(_F32) for t in (q, k, v))
        lic, lfc = logi[:, sl], logf[:, sl]            # (B, L, H)
        csf = torch.cumsum(lfc, dim=1)                 # inclusive
        ftot = csf[:, -1]                              # (B, H)

        # intra weights w[j,l] = csf[j]-csf[l]+li[l] for l<=j
        ac = csf[:, :, None, :] - csf[:, None, :, :] + lic[:, None, :, :]
        ac = torch.where(mask[None, :, :, None], ac, -1e30)
        b_in = csf + m[:, None, :]                     # carry weight
        m_j = torch.maximum(torch.amax(ac, dim=2), b_in)
        w_intra = torch.exp(ac - m_j[:, :, None, :])
        w_carry = torch.exp(b_in - m_j)

        scores = torch.einsum("bjhd,blhd->bjlh", qc, kc)
        sw = scores * w_intra
        num = (torch.einsum("bjlh,blhv->bjhv", sw, vc)
               + torch.einsum("bhkv,bjhk->bjhv", c, qc)
               * w_carry[..., None])
        den = (torch.einsum("bjlh,blhd,bjhd->bjh", sw, kc, qc)
               + torch.einsum("bhk,bjhk->bjh", n, qc) * w_carry)
        hs.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])

        # ---- state to chunk end (stabilized)
        wl = ftot[:, None, :] - csf + lic               # (B, L, H)
        m_state = torch.maximum(ftot + m, torch.amax(wl, dim=1))
        w_new = torch.exp(wl - m_state[:, None, :])
        w_old = torch.exp(ftot + m - m_state)
        c = (w_old[..., None, None] * c
             + torch.einsum("blh,blhk,blhv->bhkv", w_new, kc, vc))
        n = w_old[..., None] * n + torch.einsum("blh,blhk->bhk", w_new, kc)
        m = m_state
    return torch.cat(hs, dim=1), (c, n, m)


def mlstm_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[MlstmCache] = None,
                tp: Optional[shd.ModelGroup] = None
                ) -> tuple[torch.Tensor, Optional[MlstmCache]]:
    """x: (B, S, D) -> (out, new cache; None without one).  S == 1: the
    sequential step; else the chunkwise form, the sequence padded to a
    multiple of 64 with pad tokens that never write (``logi`` -1e30).

    With ``tp`` (the specs split ``mlstm.w_up``): ``x`` through
    ``copy_to_model`` into the column shards of ``w_up`` and ``w_gate``,
    so ``u`` and ``gate`` hold this rank's slice of the 2 d inner width;
    ``wq``, ``wk`` and ``wv`` are column shards that read the whole of
    ``u``, so ``u`` is gathered over ``model`` first, and the gates come
    from it and the whole ``w_if``/``b_if`` (through ``copy_to_model``:
    each rank's gradient of them is its heads' share).  When the heads
    split (``n_heads % tp == 0``) the rank's columns of q, k and v are its
    heads, which line up with ``gate``'s slice: it runs them alone.  Else
    (a column block that cuts a head) q, k and v are gathered to whole
    heads, every head runs on every rank, and the rank keeps its columns
    of the output.  Either way ``w_down`` is row-parallel into
    ``reduce_from_model``."""
    tp = L.split_over_model("mlstm.w_up", tp)
    b, s, _ = x.shape
    hh = cfg.n_heads
    w_if, b_if = p["w_if"], p["b_if"]
    if tp is not None:
        x = shd.copy_to_model(x, tp)
        w_if, b_if = shd.copy_to_model(w_if, tp), shd.copy_to_model(b_if, tp)
    gate = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    if tp is not None:
        u = shd.gather_from_model(u, tp)
    di = u.shape[-1]
    dh = di // hh
    q, k, v = u @ p["wq"], u @ p["wk"], u @ p["wv"]
    lo, hi = 0, hh                     # the heads this rank runs
    whole = tp is not None and hh % tp.size != 0
    if whole:
        q, k, v = (shd.gather_from_model(t, tp) for t in (q, k, v))
    elif tp is not None:
        lo, hi = tp.index * hh // tp.size, (tp.index + 1) * hh // tp.size
    hl = hi - lo
    # the scale rounded to the compute dtype, as JAX's weak scalar
    scale = torch.tensor(dh ** -0.5, dtype=x.dtype, device=x.device)
    q = q.reshape(b, s, hl, dh) * scale
    k = k.reshape(b, s, hl, dh) * scale
    v = v.reshape(b, s, hl, dh)
    gates = u.to(_F32) @ w_if + b_if
    logi, logf = gates[..., lo:hi], F.logsigmoid(gates[..., hh + lo:hh + hi])

    if cache is not None:
        c0, n0, m0 = cache.c, cache.n, cache.m
    else:
        f32 = dict(dtype=_F32, device=x.device)
        c0 = torch.zeros(b, hl, dh, dh, **f32)
        n0 = torch.zeros(b, hl, dh, **f32)
        m0 = torch.zeros(b, hl, **f32)

    if s == 1:
        hs, (c, n, m) = _mlstm_seq(q, k, v, logi, logf, c0, n0, m0)
    else:
        pad = (-s) % CHUNK
        if pad:
            def zp(a, value=0.0):
                return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad),
                             value=value)
            q, k, v = zp(q), zp(k), zp(v)
            logi = zp(logi, -1e30)                 # pad tokens never write
            logf = zp(logf)
        hs, (c, n, m) = mlstm_parallel(q, k, v, logi, logf, c0, n0, m0)
        hs = hs[:, :s]
    new_cache = MlstmCache(c=c, n=n, m=m) if cache is not None else None
    hs = hs.reshape(b, s, hl * dh)
    if whole:                          # every head ran: the rank's columns
        w = gate.shape[-1]
        hs = hs[..., tp.index * w:(tp.index + 1) * w]
    out = (hs.to(gate.dtype) * gate) @ p["w_down"]
    if tp is not None:
        out = shd.reduce_from_model(out, tp)
    return out, new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, lead: tuple = (),
                     device=None) -> MlstmCache:
    dh = 2 * cfg.d_model // cfg.n_heads
    f32 = dict(dtype=_F32, device=device)
    return MlstmCache(
        c=torch.zeros(lead + (batch, cfg.n_heads, dh, dh), **f32),
        n=torch.zeros(lead + (batch, cfg.n_heads, dh), **f32),
        m=torch.zeros(lead + (batch, cfg.n_heads), **f32))


# ======================================================================
# sLSTM
# ======================================================================

@dataclasses.dataclass
class SlstmCache(L.StateCache):
    h: torch.Tensor    # (..., B, D)
    c: torch.Tensor    # (..., B, D)
    n: torch.Tensor    # (..., B, D)
    m: torch.Tensor    # (..., B, D)


def init_slstm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    hh = cfg.n_heads
    dh = d // hh
    dt = L.dtype_of(cfg)
    dev = generator.device
    return {
        "w_x": _tn(generator, (d, 4 * d), d, dt),
        "r_h": _tn(generator, (hh, dh, 4 * dh), dh, _F32),
        "b": torch.cat([torch.zeros(2 * d, device=dev),
                        torch.linspace(3.0, 6.0, d, device=dev),  # forget
                        torch.zeros(d, device=dev)]),
        "w_up1": _tn(generator, (d, 2 * d), d, dt),
        "w_up2": _tn(generator, (d, 2 * d), d, dt),
        "w_down": _tn(generator, (2 * d, d), 2 * d, dt),
    }


def _slstm_cell(p, cfg, xg, state):
    """One step.  xg: (B, 4D) precomputed x-part; state (h, c, n, m).
    The recurrent part is laid out head-major, (B, H, 4 Dh) flattened,
    and the z/i/f/o gates are its contiguous D-wide quarters, as in
    JAX."""
    d = cfg.d_model
    hh = cfg.n_heads
    h, c, n, m = state
    rec = torch.einsum("bhd,hdk->bhk", h.reshape(-1, hh, d // hh),
                       p["r_h"]).reshape(-1, 4 * d)
    g = xg.to(_F32) + rec + p["b"]
    zt = torch.tanh(g[:, 0 * d:1 * d])
    it = g[:, 1 * d:2 * d]                       # log-space input gate
    ft = F.logsigmoid(g[:, 2 * d:3 * d])         # log forget
    ot = torch.sigmoid(g[:, 3 * d:4 * d])
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def slstm_scan(p: Params, cfg: ModelConfig, xg: torch.Tensor, state):
    """The time loop: every step's h (B, S, D) float32 and the last
    state, from the x-parts ``xg`` (B, S, 4D)."""
    hs = []
    for t in range(xg.shape[1]):
        state = _slstm_cell(p, cfg, xg[:, t], state)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


def slstm_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[SlstmCache] = None,
                tp: Optional[shd.ModelGroup] = None
                ) -> tuple[torch.Tensor, Optional[SlstmCache]]:
    """x: (B, S, D) -> (out, new cache; None without one).

    With ``tp``: a column shard of ``w_x`` holds whole z/i/f/o quarters
    of the gates, not heads, and the recurrent part adds ``r_h``'s
    head-major output to them, so ``x @ w_x`` is gathered over ``model``
    once a block (the gather's backward keeps the rank's slice) and the
    time loop runs on every rank with ``r_h`` and ``b`` whole.  ``hs`` is
    then whole: through ``copy_to_model`` into the column shards of
    ``w_up1``/``w_up2`` and the row-parallel ``w_down`` into
    ``reduce_from_model``.  Each split follows its leaf's spec."""
    tp_x = L.split_over_model("slstm.w_x", tp)
    tp_up = L.split_over_model("slstm.w_up1", tp)
    b, s, d = x.shape
    if tp_x is not None:
        x = shd.copy_to_model(x, tp_x)
    xg = x @ p["w_x"]                              # (B, S, 4D)
    if tp_x is not None:
        xg = shd.gather_replicated(xg, tp_x, -1)
    if cache is not None:
        st = (cache.h, cache.c, cache.n, cache.m)
    else:
        z = torch.zeros(b, d, dtype=_F32, device=x.device)
        st = (z, z, z, z)                          # m starts at 0
    hs, st = slstm_scan(p, cfg, xg, st)
    hs = hs.to(x.dtype)                            # (B, S, D)
    new_cache = SlstmCache(*st) if cache is not None else None
    if tp_up is not None:
        hs = shd.copy_to_model(hs, tp_up)
    out = (F.silu(hs @ p["w_up1"]) * (hs @ p["w_up2"])) @ p["w_down"]
    if tp_up is not None:
        out = shd.reduce_from_model(out, tp_up)
    return out, new_cache


def init_slstm_cache(cfg: ModelConfig, batch: int, lead: tuple = (),
                     device=None) -> SlstmCache:
    shape = lead + (batch, cfg.d_model)
    return SlstmCache(*(torch.zeros(shape, dtype=_F32, device=device)
                        for _ in range(4)))
