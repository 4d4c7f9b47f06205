"""The sequential (pre-refactor) collective simulator: a verification
oracle (port of ``repro/core/transport/reference.py``).

This is the original step-at-a-time loop, ``rounds x 2(N-1)`` ring steps
in Python over numpy, kept for two jobs:

- **verification**: the batched engine's legacy-stream mode must
  reproduce its seeded statistics (the IRN, SRNIC and fixed-window
  Celeris paths round by round, because their streams are replayed bit
  for bit; RoCE statistically);
- **benchmarking**: Fig. 2's ``fig2_engine_speedup_x`` times this loop
  against the engine (``benchmarks.figs.fig2_sequential``).

It is host code by nature and takes no device: one DCQCN update a ring
step (``dcqcn.step``, numpy), one ``ClosFabric`` tick, one
``_transfer_reference`` call.  It launches no kernel, and no path on the
card falls back to it.  It is one to two orders of magnitude slower than
``engine.BatchedEngine``; do not use it for studies.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import timeout as timeout_mod
from repro_torch.core.transport import dcqcn, designs
from repro_torch.core.transport.engine import RoundStats
from repro_torch.core.transport.network import ClosFabric
from repro_torch.core.transport.params import SimParams


def _transfer_reference(design, n_pkts, occ, rate, drop_p, pfc_pause,
                        queue_delay, rel, net, rng):
    """The original dense-draw transfer model, byte for byte.

    :func:`designs.transfer` draws loss variates only on the
    drop-capable subset (the same distribution, another stream order);
    the reference keeps the dense consumption of the seed
    implementation, so its seeded streams, which the engine's replay mode
    reproduces, stay those of the pre-refactor simulator.
    """
    n_flows = occ.shape[0]
    pkt_time = net.pkt_time_us / np.maximum(rate, 1e-3)
    serialize = n_pkts * pkt_time
    base = serialize + queue_delay + net.base_rtt_us / 2

    if design == "roce":
        p = drop_p * designs.PFC_DROP_SUPPRESSION
        k = rng.binomial(n_pkts, p)
        tail_lost = rng.random(n_flows) < p
        extra = np.zeros(n_flows)
        remaining = k.copy()
        for _ in range(rel.max_retries):
            has_loss = remaining > 0
            pos = rng.integers(0, n_pkts, n_flows)
            n_resend = np.where(has_loss, n_pkts - pos, 0)
            detect = np.where(tail_lost, rel.rto_us,
                              rel.nack_delay_us + net.base_rtt_us)
            extra += np.where(has_loss, detect + n_resend * pkt_time, 0.0)
            remaining = rng.binomial(np.maximum(n_resend, 0), p)
            tail_lost = tail_lost & (rng.random(n_flows) < p)
        t = base + extra + pfc_pause
        full = np.full(n_flows, n_pkts)
        return designs.TransferResult(t, full, full)

    if design in ("irn", "srnic"):
        k = rng.binomial(n_pkts, drop_p)
        tail_lost = rng.random(n_flows) < drop_p
        detect = np.where(tail_lost, rel.rto_low_us,
                          rel.nack_delay_us + net.base_rtt_us)
        extra = np.where(k > 0, detect + k * pkt_time, 0.0)
        if design == "srnic":
            extra += k * rel.host_slowpath_us
        k2 = rng.binomial(k, drop_p)
        extra += np.where(k2 > 0, rel.rto_low_us + k2 * pkt_time, 0.0)
        t = base + extra
        full = np.full(n_flows, n_pkts)
        return designs.TransferResult(t, full, full)

    if design == "celeris":
        k = rng.binomial(n_pkts, drop_p)
        t = (serialize + designs.CELERIS_QUEUE_OVERLAP * queue_delay
             + net.base_rtt_us / 2)
        full = np.full(n_flows, n_pkts)
        return designs.TransferResult(t, n_pkts - k, full)

    raise ValueError(design)


class SequentialCollectiveSimulator:
    """The pure-Python ``rounds x 2(N-1)`` reference loop."""

    def __init__(self, params: SimParams | None = None):
        self.p = params or SimParams()

    def run(self, design: str, n_rounds: int = 400, *,
            celeris_timeout_us: float | None = None,
            adaptive: bool = True, window: str = "round",
            seed: int | None = None) -> RoundStats:
        p = self.p
        net, rel = p.net, p.rel
        rng = np.random.default_rng(p.seed if seed is None else seed)
        fabric = ClosFabric(net, seed=int(rng.integers(2**31)))

        n = net.n_nodes
        steps = 2 * (n - 1)
        chunk_bytes = p.work.message_bytes // n
        n_pkts = max(1, chunk_bytes // net.mtu_bytes)
        src = np.arange(n)
        dst = (src + 1) % n

        cc = dcqcn.HostDcqcnState.init(n)

        controllers = None
        if design == "celeris":
            init_to = (celeris_timeout_us or 50_000.0) / 1e6
            cfg = timeout_mod.TimeoutConfig(
                init_timeout=init_to, min_timeout=init_to * 0.25,
                max_timeout=init_to * 8.0, alpha=0.25)
            controllers = [timeout_mod.TimeoutController(cfg)
                           for _ in range(n)]

        times = np.zeros(n_rounds)
        fracs = np.ones(n_rounds)

        for r in range(n_rounds):
            if controllers is not None:
                round_budget_us = controllers[0].timeout * 1e6
                step_timeout_us = round_budget_us / steps

            step_nat = np.zeros(steps)
            step_deliv = np.zeros(steps)
            step_total = np.zeros(steps)

            for s in range(steps):
                fabric.advance()
                occ = fabric.path_occupancy(src, dst)
                drop_p = fabric.drop_prob(occ)
                qd = fabric.queue_delay_us(occ)
                pfc = (fabric.pfc_pause_us(occ) if design == "roce"
                       else np.zeros(n))

                eff_rate = cc.rate * fabric.avail_bandwidth(occ)
                res = _transfer_reference(design, n_pkts, occ, eff_rate,
                                          drop_p, pfc, qd, rel, net, rng)

                if design == "celeris" and window == "step":
                    t_nat = float(res.time_us.max())
                    step_nat[s] = min(t_nat, step_timeout_us)
                    late_frac = np.clip(
                        (res.time_us - step_timeout_us)
                        / np.maximum(res.time_us, 1e-9), 0, 1)
                    step_deliv[s] = float(
                        (res.delivered_pkts * (1 - late_frac)).sum())
                else:
                    step_nat[s] = float(res.time_us.max())
                    step_deliv[s] = float(res.delivered_pkts.sum())
                step_total[s] = float(res.total_pkts.sum())

                cnp = rng.random(n) < fabric.ecn_mark_prob(occ)
                cc = dcqcn.step(cc, cnp, p.dcqcn)

            if design == "celeris" and window == "round":
                cum = np.cumsum(step_nat)
                total_t = float(cum[-1])
                if total_t <= round_budget_us:
                    times[r] = total_t
                    fracs[r] = step_deliv.sum() / max(step_total.sum(), 1.0)
                else:
                    times[r] = round_budget_us
                    done = cum <= round_budget_us
                    bidx = int(np.argmax(~done))
                    prev = float(cum[bidx - 1]) if bidx > 0 else 0.0
                    part = (round_budget_us - prev) / max(step_nat[bidx],
                                                          1e-9)
                    got = step_deliv[done].sum() + step_deliv[bidx] * part
                    fracs[r] = got / max(step_total.sum(), 1.0)
            else:
                times[r] = step_nat.sum()
                fracs[r] = step_deliv.sum() / max(step_total.sum(), 1.0)

            if controllers is not None and adaptive:
                node_frac = np.clip(
                    fracs[r] + rng.normal(0, 0.002, n), 0.0, 1.0)
                local = [c.update(times[r] / 1e6, node_frac[i])
                         for i, c in enumerate(controllers)]
                agreed = timeout_mod.coordinate(local)
                for c in controllers:
                    c.adopt(agreed)

        return RoundStats(times_us=times, recv_frac=fracs, design=design)
