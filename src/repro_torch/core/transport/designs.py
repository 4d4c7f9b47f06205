"""The four NIC designs' loss machinery (port of
``repro/core/transport/designs.py``: the constants, the shared draw
helpers and the step-at-a-time :func:`transfer`).

- **RoCE**: go-back-N; tail losses wait for the retransmission timeout;
  PFC suppresses most overflow drops but pauses head-of-line block.
- **IRN**: selective repeat, low RTO on tail loss.
- **SRNIC**: selective repeat in host software (IRN plus a slow-path
  penalty per loss).
- **Celeris**: no recovery; lost packets are simply absent and the
  bounded window cuts late data.

The draw helpers are numpy, copied as they are: they consume the
per-design transfer streams, and their draw *order* is the replay
contract.  The draws depend only on the drop curve, never on the DCQCN
rate, which is what lets the engine split each design into a host draw
pass and a rate-dependent time assembly on the device
(``engine_torch``).  :func:`transfer` is the whole per-flow completion
model on the host, which the sequential reference loop
(``reference.py``) calls once a ring step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.transport.params import NetworkParams, ReliabilityParams

DESIGNS = ("roce", "irn", "srnic", "celeris")

# RoCE runs PFC: overflow drops are largely prevented (residual drops
# from corruption / buffer carving remain).
PFC_DROP_SUPPRESSION = 0.15

# Celeris's push engine streams with no ACK/window clocking, so queueing
# *latency* (not bandwidth) overlaps across in-flight chunks; only this
# residual fraction shows up in completion time.  Reliable designs pay
# the full per-chunk queue delay.
CELERIS_QUEUE_OVERLAP = 0.15


@dataclasses.dataclass
class TransferResult:
    time_us: np.ndarray       # completion time per flow
    delivered_pkts: np.ndarray
    total_pkts: np.ndarray


def roce_loss_episodes(n_pkts: int, pf: np.ndarray,
                       rel: ReliabilityParams, net: NetworkParams,
                       rng: np.random.Generator) -> list:
    """The go-back-N recovery draws over a drop-capable subset.

    Returns ``max_retries`` episodes of ``(has_loss, n_resend,
    detect_us)``; completion-time excess is ``sum(where(has_loss,
    detect + n_resend * pkt_time, 0))`` over the episodes.  No draw
    depends on an accumulated time, so hoisting them out of the
    accumulation loop consumes the stream identically.
    """
    k = rng.binomial(n_pkts, pf)
    tail_lost = rng.random(pf.size) < pf    # last pkt's own fate
    episodes = []
    remaining = k
    for _ in range(rel.max_retries):
        has_loss = remaining > 0
        pos = rng.integers(0, n_pkts, pf.size)  # first-loss position
        n_resend = np.where(has_loss, n_pkts - pos, 0)
        detect = np.where(tail_lost, rel.rto_us,
                          rel.nack_delay_us + net.base_rtt_us)
        episodes.append((has_loss, n_resend, detect))
        # losses within the retransmitted burst
        remaining = rng.binomial(n_resend, pf)
        tail_lost = tail_lost & (rng.random(pf.size) < pf)
    return episodes


def sr_loss_draws(n_pkts: int, pf: np.ndarray, rng: np.random.Generator
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Selective-repeat (irn / srnic) loss draws over a drop-capable
    subset: ``(k, tail_lost, k2)``: first-round losses, the last
    packet's own fate, and the re-lost second round."""
    k = rng.binomial(n_pkts, pf)
    tail_lost = rng.random(pf.size) < pf
    k2 = rng.binomial(k, pf)
    return k, tail_lost, k2


def celeris_loss_draws(n_pkts: int, pf: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    """Celeris drop draws over a drop-capable subset: packets that
    simply never arrive (no recovery)."""
    return rng.binomial(n_pkts, pf)


def transfer(design: str, n_pkts: int, occ: np.ndarray, rate: np.ndarray,
             drop_p: np.ndarray, pfc_pause: np.ndarray, queue_delay: np.ndarray,
             rel: ReliabilityParams, net: NetworkParams,
             rng: np.random.Generator,
             parts: dict | None = None) -> TransferResult:
    """Completion time of an n_pkts chunk per concurrent flow.

    Shape-polymorphic: every per-flow array may carry leading batch axes
    (``(n_flows,)`` a ring step, ``(step, n_flows)`` a block).  The loss
    machinery runs on the drop-capable subset only (the drop probability
    is exactly 0 below the loss knee); the distribution per entry is
    that of a dense sweep, the draw order is the helpers'.

    ``parts``, when a dict is passed, records the component arrays this
    function computes anyway (serialization, queueing, RTT, PFC pause,
    retransmit time, wire-lost packets), scalar or full-shape, without
    touching the arithmetic or the draw streams.
    """
    shape = occ.shape
    pkt_time = net.pkt_time_us / np.maximum(rate, 1e-3)
    serialize = n_pkts * pkt_time
    full = np.broadcast_to(np.float64(n_pkts), shape)
    if parts is not None:
        parts["serialize"] = serialize
        parts["rtt"] = net.base_rtt_us / 2

    if design == "roce":
        p = drop_p * PFC_DROP_SUPPRESSION
        idx = np.flatnonzero(p > 0)
        t = serialize + queue_delay + net.base_rtt_us / 2
        t += pfc_pause
        if parts is not None:
            parts["queue"] = queue_delay
            parts["pfc"] = pfc_pause
        if idx.size:
            pf = np.ascontiguousarray(p).ravel()[idx]
            ptf = np.ascontiguousarray(pkt_time).ravel()[idx]
            ex = np.zeros(idx.size)
            # go-back-N episodes, accumulated in the helper's order
            for has_loss, n_resend, detect in roce_loss_episodes(
                    n_pkts, pf, rel, net, rng):
                ex += np.where(has_loss, detect + n_resend * ptf, 0.0)
            # .flat, not .ravel(): a non-C-contiguous block (an advanced-
            # indexed view) would make ravel() return a copy, and the
            # in-place update would be lost
            t.flat[idx] += ex.astype(t.dtype)
            if parts is not None:
                rx = np.zeros(shape)
                rx.flat[idx] = ex
                parts["retransmit"] = rx
        return TransferResult(t, full, full)

    if design in ("irn", "srnic"):
        idx = np.flatnonzero(drop_p > 0)
        t = serialize + queue_delay + net.base_rtt_us / 2
        if parts is not None:
            parts["queue"] = queue_delay
        if idx.size:
            pf = np.ascontiguousarray(drop_p).ravel()[idx]
            ptf = np.ascontiguousarray(pkt_time).ravel()[idx]
            k, tail_lost, k2 = sr_loss_draws(n_pkts, pf, rng)
            detect = np.where(tail_lost, rel.rto_low_us,
                              rel.nack_delay_us + net.base_rtt_us)
            ex = np.where(k > 0, detect + k * ptf, 0.0)
            if design == "srnic":
                ex += k * rel.host_slowpath_us      # host slow-path per loss
            # selective-repeat second round for re-lost packets
            ex += np.where(k2 > 0, rel.rto_low_us + k2 * ptf, 0.0)
            t.flat[idx] += ex.astype(t.dtype)
            if parts is not None:
                rx = np.zeros(shape)
                rx.flat[idx] = ex
                parts["retransmit"] = rx
        return TransferResult(t, full, full)

    if design == "celeris":
        idx = np.flatnonzero(drop_p > 0)
        delivered = np.full(shape, n_pkts, dtype=serialize.dtype)
        if idx.size:
            pf = np.ascontiguousarray(drop_p).ravel()[idx]
            delivered.flat[idx] -= celeris_loss_draws(n_pkts, pf, rng)
        # no recovery: wire time only; lost packets never arrive, and the
        # streaming push hides most of the queueing latency
        t = (serialize + CELERIS_QUEUE_OVERLAP * queue_delay
             + net.base_rtt_us / 2)
        if parts is not None:
            parts["queue"] = CELERIS_QUEUE_OVERLAP * queue_delay
            parts["wire_lost"] = np.asarray(full - delivered, np.float64)
        return TransferResult(t, delivered, full)

    raise ValueError(design)
