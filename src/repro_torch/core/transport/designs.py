"""The four NIC designs' loss machinery (port of
``repro/core/transport/designs.py``: the constants and the shared draw
helpers).

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
(``engine_torch``).
"""
from __future__ import annotations

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
