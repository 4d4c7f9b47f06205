"""Clos fabric + background-contention model (port of
``repro/core/transport/network.py``: the parts the engine runs; the
step-at-a-time ``ClosFabric`` is left out).

Background load is a Markov-modulated burst process per ToR uplink
(on/off with occupancy drawn per burst).  Occupancy determines queueing
delay, ECN marking probability, drop probability and (for RoCE) PFC
pause events.

Two kinds of code live here:

- the **host pass** (numpy, copied as it is): :func:`occupancy_trace`
  resolves the burst chain in closed form and the occupancy EWMA by a
  truncated geometric filter, consuming the fabric stream in exactly the
  numpy engine's order, :func:`pfc_pause_trace` consumes the PFC
  stream, and :func:`roce_fabric_trace` replays the fabric stream as a
  seed RoCE run of the sequential simulator consumed it (legacy
  streams).  These consume random streams, so they stay on numpy
  generators: that is the replay contract;
- the **response curves**, written once for both numpy arrays and torch
  tensors (operator and method syntax only: ``**`` and ``.clip`` exist
  on both), so the host pass and the device core evaluate one formula.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.transport.params import NetworkParams


@dataclasses.dataclass
class FabricState:
    """Per-ToR burst state carried from one engine block to the next."""
    bursting: np.ndarray      # (n_tors,) bool
    occupancy: np.ndarray     # (n_tors,) current uplink occupancy


# ----------------------------------------------------------------------
# Fabric response curves: one formula source for the host pass (numpy)
# and the device core (torch).  The stream replay depends on every
# consumer agreeing on where the drop probability is exactly zero, so
# never fork these formulas.
# ----------------------------------------------------------------------

def queue_delay_us(p: NetworkParams, occ):
    return p.queue_capacity_us * occ ** 3


def avail_bandwidth(p: NetworkParams, occ):
    return (1.0 - p.bg_bandwidth_weight * occ).clip(p.min_avail_frac, 1.0)


def ecn_mark_prob(p: NetworkParams, occ):
    return ((occ - p.ecn_threshold) / (1 - p.ecn_threshold)).clip(0, 1)


def drop_prob(p: NetworkParams, occ):
    x = ((occ - p.loss_knee) / (1 - p.loss_knee)).clip(0, 1)
    return p.loss_max_prob * x ** 2


def congestion_counters(p: NetworkParams, occ: np.ndarray,
                        drop_p: np.ndarray | None = None) -> dict:
    """Per-step fabric congestion summary for the flight recorder's
    counter tracks (``telemetry.TraceRecorder.record_fabric``): mean and
    max path occupancy, the fraction of flows past the ECN knee, and
    (when the drop curve is at hand) the mean drop probability.
    Reductions of the host pass's ``(step, flow)`` blocks, no draws."""
    out = {"occ_mean": occ.mean(axis=-1).astype(np.float64),
           "occ_max": occ.max(axis=-1).astype(np.float64),
           "ecn_frac": (occ > p.ecn_threshold).mean(axis=-1)}
    if drop_p is not None:
        out["drop_p_mean"] = drop_p.mean(axis=-1).astype(np.float64)
    return out


# ----------------------------------------------------------------------
# Vectorized traces (the engine's fabric front-end, host side)
# ----------------------------------------------------------------------

# Doubles consumed by one step of the burst process: start + stop +
# burst occupancy draws.
_ADVANCE_DRAWS = 3


def _markov_burst(b0: np.ndarray, start: np.ndarray,
                  stop: np.ndarray) -> np.ndarray:
    """Closed-form burst state for all steps at once.

    Per step the transition  b' = (b & ~stop) | (~b & start)  is one of
    four maps on {0,1}: const-0 (stop only), const-1 (start only),
    identity (neither), swap (both).  Composing over steps: the state at
    t is the value of the last constant map at or before t, XOR'd with
    the parity of swaps after it (or b0 if no constant map yet).
    """
    T = start.shape[0]
    const = start ^ stop                   # exactly one of start/stop
    swap = start & stop
    t_idx = np.arange(T)[(slice(None),) + (None,) * (start.ndim - 1)]
    last_const = np.maximum.accumulate(np.where(const, t_idx, -1), axis=0)
    cs = np.cumsum(swap, axis=0)           # swaps in [0, t], inclusive
    gather = np.clip(last_const, 0, None)
    val_at = np.take_along_axis(np.where(const, start, False), gather, axis=0)
    cs_at = np.take_along_axis(cs, gather, axis=0)
    has_const = last_const >= 0
    base = np.where(has_const, val_at, np.broadcast_to(b0, start.shape))
    n_swaps = np.where(has_const, cs - cs_at, cs)
    return base ^ (n_swaps % 2 == 1)


def _ewma_half(target: np.ndarray, occ0: np.ndarray,
               seg: int = 512) -> np.ndarray:
    """occ[t] = 0.5*occ[t-1] + 0.5*target[t], all t at once, bitwise
    identical to the sequential recurrence.

    Closed form via exponentially scaled prefix sums::

        occ[t] = 0.5**(t+1) * cumsum([occ0, 2**0*target[0],
                                      2**1*target[1], ...])[t+1]

    Power-of-two scaling is exact in IEEE-754 and commutes with
    round-to-nearest, and the cumsum folds ``occ0`` first (the same
    association order as the recurrence), so every step rounds exactly
    as the sequential loop does.  Evaluated in ``seg``-step segments so
    the 2**s scale stays far from the f64 exponent limit.
    """
    T = target.shape[0]
    out = np.empty_like(target)
    trail = (None,) * (target.ndim - 1)
    prev = occ0
    for a in range(0, T, seg):
        b = min(a + seg, T)
        s = np.arange(b - a)
        up = np.exp2(s)[(slice(None),) + trail]
        down = np.exp2(-(s + 1.0))[(slice(None),) + trail]
        ext = np.concatenate(
            [np.broadcast_to(prev, (1,) + target.shape[1:]),
             target[a:b] * up], axis=0)
        out[a:b] = down * np.cumsum(ext, axis=0)[1:]
        prev = out[b - 1]
    return out


def occupancy_trace(p: NetworkParams, u: np.ndarray, state: FabricState
                    ) -> tuple[np.ndarray, np.ndarray, FabricState]:
    """Vectorized ``T`` steps of the burst process.

    ``u``: (T, 3, n_tors) uniforms laid out exactly as ``T`` sequential
    steps consume them (start, stop, burst_occ per step), so
    ``rng.random((T, 3, n_tors))`` reproduces seeded traces
    bit-identically.  Returns (bursting, occupancy, final_state).
    """
    start = u[:, 0] < p.burst_on_prob
    stop = u[:, 1] < p.burst_off_prob
    burst_occ = (p.burst_occupancy_lo
                 + (p.burst_occupancy_hi - p.burst_occupancy_lo) * u[:, 2])
    b = _markov_burst(state.bursting, start, stop)
    target = np.where(b, burst_occ, p.idle_occupancy)
    occ = _ewma_half(target, state.occupancy)
    final = FabricState(bursting=b[-1].copy(), occupancy=occ[-1].copy())
    return b, occ, final


def path_occupancy_trace(p: NetworkParams, occ: np.ndarray, src: np.ndarray,
                         dst: np.ndarray) -> np.ndarray:
    """Per-transfer path occupancy for a whole trace: ``occ`` (..., T,
    n_tors) -> (..., T, n_flows).  A cross-ToR path sees the max of its
    two uplinks; a same-ToR path the idle occupancy."""
    ts = src // p.nodes_per_tor
    td = dst // p.nodes_per_tor
    cross = np.maximum(occ[..., ts], occ[..., td])
    return np.where(ts == td, p.idle_occupancy, cross)


def pfc_pause_trace(p: NetworkParams, occ: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """Vectorized PFC pause totals over a (..., n_flows) occupancy block.

    A pause on a path whose occupancy passes ``pfc_threshold``
    propagates a further hop with probability ``pfc_cascade_prob``
    (geometric storm, capped); draws only for still-alive entries.
    """
    paused = occ > p.pfc_threshold
    total = np.where(paused, p.pfc_pause_us, 0.0)
    alive = paused.copy()
    for _ in range(p.pfc_max_cascade):
        idx = np.flatnonzero(alive)
        if idx.size == 0:
            break
        survive = rng.random(idx.size) < p.pfc_cascade_prob
        # .flat, not .ravel(): ravel() copies on non-contiguous blocks
        # and the write would be lost
        alive.flat[idx] = survive
        total.flat[idx] += np.where(survive, p.pfc_pause_us, 0.0)
    return total


def roce_fabric_trace(p: NetworkParams, fabric_seed: int, src: np.ndarray,
                      dst: np.ndarray, n_steps: int, *, window: int = 512,
                      window_max: int = 16384) -> tuple[np.ndarray, np.ndarray]:
    """Bit-exact replay of the fabric stream as a seed RoCE run consumes it.

    Per step the sequential simulator draws 3*n_tors doubles in
    ``advance()`` and then >= 1 cascade block of ``n_flows`` doubles in
    ``pfc_pause_us`` — further blocks only while some cascade survives,
    which is rare (strong bursts only).  We therefore speculate
    ``window`` steps at a time assuming the one-block common case, find
    the first step whose cascade survives its first draw, finish that
    step's cascade sequentially, and re-anchor the stream position with
    ``PCG64.advance``.

    Returns (occupancy (T, n_tors), pfc_pause_us (T, n_flows)).
    """
    n_tors = p.n_nodes // p.nodes_per_tor
    n = src.shape[0]
    step_draws = _ADVANCE_DRAWS * n_tors + n
    state = FabricState(bursting=np.zeros(n_tors, dtype=bool),
                        occupancy=np.full(n_tors, p.idle_occupancy))
    out_occ = np.empty((n_steps, n_tors))
    out_pfc = np.empty((n_steps, n))
    t = 0
    offset = 0                                # doubles consumed so far
    win = window                              # adaptive: grow while calm,
    while t < n_steps:                        # shrink on cascade breaks
        L = min(win, n_steps - t)
        bg = np.random.PCG64(fabric_seed)
        bg.advance(offset)
        gen = np.random.Generator(bg)
        u = gen.random((L, step_draws))
        b, occ, spec_state = occupancy_trace(
            p, u[:, : _ADVANCE_DRAWS * n_tors].reshape(L, _ADVANCE_DRAWS,
                                                       n_tors), state)
        # ToR-level prescreen: a path can only pause when some ToR
        # exceeds the threshold (same-ToR paths sit at idle occupancy),
        # which is rare — skip the per-flow work for cold steps.
        hot = (occ > p.pfc_threshold).any(axis=1)
        hidx = np.flatnonzero(hot)
        paused_h = np.zeros((hidx.size, n), dtype=bool)
        if hidx.size:
            occ_path_h = path_occupancy_trace(p, occ[hidx], src, dst)
            paused_h = occ_path_h > p.pfc_threshold
        alive1_h = paused_h & (
            u[hidx, _ADVANCE_DRAWS * n_tors:] < p.pfc_cascade_prob)
        cont_h = alive1_h.any(axis=1)
        j = int(hidx[np.argmax(cont_h)]) if cont_h.any() else L
        upto = min(j + 1, L)
        out_occ[t: t + upto] = occ[:upto]
        out_pfc[t: t + upto] = 0.0
        keep_h = hidx[hidx < upto]
        if keep_h.size:
            out_pfc[t + keep_h] = np.where(paused_h[: keep_h.size],
                                           p.pfc_pause_us, 0.0)
        if j < L:
            # step t+j: cascade survived its first draw — replay the
            # remaining iterations sequentially at the exact position.
            bg2 = np.random.PCG64(fabric_seed)
            extra_offset = offset + (j + 1) * step_draws
            bg2.advance(extra_offset)
            gen2 = np.random.Generator(bg2)
            alive = alive1_h[int(np.argmax(cont_h))].copy()
            total = out_pfc[t + j]
            total += np.where(alive, p.pfc_pause_us, 0.0)
            draws = 1
            while draws < p.pfc_max_cascade:
                alive = alive & (gen2.random(n) < p.pfc_cascade_prob)
                draws += 1
                if not alive.any():
                    break
                total += np.where(alive, p.pfc_pause_us, 0.0)
            offset = extra_offset + (draws - 1) * n
            # resume from the state *after* step t+j
            state = FabricState(bursting=b[j].copy(), occupancy=occ[j].copy())
            t += j + 1
            win = window
        else:
            state = spec_state
            offset += L * step_draws
            t += L
            win = min(win * 2, window_max)
    return out_occ, out_pfc
