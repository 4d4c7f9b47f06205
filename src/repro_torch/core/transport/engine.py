"""Batched transport engine, shared-fabric flat-ring path (port of
``repro/core/transport/engine.py``).

The engine materializes the simulation as ``(step, node)`` blocks:
``step`` is the flattened ``round * ring_step`` time axis, ``node`` the
concurrent ring flows.  Work proceeds in *round blocks* sized to a fixed
element budget.  All NIC designs of one seed share one fabric trace and
one DCQCN rate trace (``legacy_streams=False``, the shared-fabric mode).

Where the work runs (``engine_torch`` has the details):

- the host pass replays the numpy engine's random streams with numpy
  generators, block for block in its exact order: fabric occupancy,
  path curves, CNP draws, PFC and loss draws;
- the device core runs the rate-dependent physics as torch ops on
  ``device``, with the seed axis batched: the DCQCN recurrence in one
  hand-written CUDA kernel launch per block (``kernels/csrc/dcqcn.cu``),
  the response curves, per-design completion times and the per-step
  reductions;
- the round assembly (:meth:`BatchedEngine.assemble`: round windows,
  fixed or adaptive) runs on the host over the reduced step traces.

The reference is the numpy engine with ``legacy_streams=False``: the
same host draws, so delivered packets are exact, and times and fractions
agree within rtol 1e-5 (the device core regroups a few float
accumulations, as ``engine_jax`` does).

Out of this path, and raising ``NotImplementedError`` (ROADMAP, Queue 1
items 5-6): ``legacy_streams=True``, ``n_pods > 1``, schedules other
than the ring and FlowPlan overrides, active faults, a telemetry
recorder, ``cut_order="priority"``, ``window="step"`` and
``per_node_for``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import timeout as timeout_mod
from repro_torch.core.transport import designs, network, topology
from repro_torch.core.transport import schedule as schedule_mod
from repro_torch.core.transport.params import SimParams, WindowPolicy

# Engine-native random sub-streams, all derived from the user seed
# (the numpy engine's ids: the port must consume the same streams).
# irn and srnic intentionally share one transfer stream.
_STREAM_CNP = 101          # clean-trace CNP draws (shared by designs)
_STREAM_PFC = 103          # PFC cascade draws (shared-fabric mode only)
_STREAM_TRANSFER = {"roce": 110, "irn": 111, "srnic": 111, "celeris": 112}
_STREAM_WINDOW = 120       # bounded-window controller observation noise

# Round-block sizing: bound the (step, node) chunk to this many elements
# so peak memory is flat in cluster size.  Not a tuning knob: the host
# pass must consume the streams in the numpy engine's block partition.
_BLOCK_ELEMENTS = 4 << 20


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch engine yet (ROADMAP, Queue 1 "
        "items 5-6); the port runs the shared-fabric flat ring")


def _tier_frac(got: np.ndarray, tot: np.ndarray) -> np.ndarray:
    """Delivered fraction per tier; empty tiers report 1 (nothing to
    lose)."""
    return np.where(tot > 0, got / np.maximum(tot, 1.0), 1.0)


def _cut_block(nat_b, deliv_b, budget_us, groups):
    """Apply one deadline to a contiguous run of steps (arrival order).

    Elapsed time is ``min(sum(nat), budget)``; packets delivered strictly
    inside the deadline count in full and the boundary step earns linear
    partial credit.  ``groups`` are (steps, G) per-group delivered
    arrays that take the same cut.  Returns ``(elapsed, got,
    group_gots)``.
    """
    cum = np.cumsum(nat_b)
    total_t = cum[-1]
    if total_t <= budget_us:
        return total_t, deliv_b.sum(), [g.sum(axis=0) for g in groups]
    done = cum <= budget_us
    bidx = int(np.argmax(~done))
    prev = float(cum[bidx - 1]) if bidx > 0 else 0.0
    part = (budget_us - prev) / max(nat_b[bidx], 1e-9)
    got = deliv_b[done].sum() + deliv_b[bidx] * part
    return budget_us, got, [(g * done[:, None]).sum(0) + g[bidx] * part
                            for g in groups]


@dataclasses.dataclass
class RoundStats:
    times_us: np.ndarray          # (rounds,)
    recv_frac: np.ndarray         # (rounds,) delivered fraction of payload
    design: str
    # per-tier delivered fractions (topology.TIERS order)
    tier_recv_frac: np.ndarray | None = None    # (rounds, n_tiers)
    tier_counts: np.ndarray | None = None       # (n_tiers,) flows per tier
    tier_pkts: np.ndarray | None = None         # (n_tiers,) offered/round
    # per-priority-class delivered fractions and offered packets
    prio_recv_frac: np.ndarray | None = None
    prio_pkts: np.ndarray | None = None
    # per round, steps with >= 1 faulted flow (None: fault-free, always
    # so in the port until faults are ported)
    fault_steps: np.ndarray | None = None

    @property
    def p50(self) -> float:
        return float(np.percentile(self.times_us, 50))

    @property
    def p99(self) -> float:
        return float(np.percentile(self.times_us, 99))

    @property
    def p999(self) -> float:
        return float(np.percentile(self.times_us, 99.9))

    @property
    def mean_loss(self) -> float:
        return float(1.0 - self.recv_frac.mean())

    @property
    def faulted(self) -> np.ndarray:
        """(rounds,) bool: rounds with at least one faulted flow."""
        if self.fault_steps is None:
            return np.zeros(self.times_us.shape[0], dtype=bool)
        return np.asarray(self.fault_steps) > 0


@dataclasses.dataclass
class StepTrace:
    """Reduced per-step physics for one design (full trace length T):
    ``(T,)`` reductions over nodes, per-tier ``(T, n_tiers)`` sums, and
    the plan facts the window assembly reads."""
    design: str
    steps_per_round: int
    nat_us: np.ndarray            # max over nodes of completion time
    deliv: np.ndarray             # delivered packets summed over nodes
    total: np.ndarray             # offered packets summed over nodes
    tier_deliv: np.ndarray | None = None
    tier_total: np.ndarray | None = None
    tier_counts: np.ndarray | None = None       # (n_tiers,) flows per tier
    tier_pkts_round: np.ndarray | None = None   # (n_tiers,) offered/round
    step_priority: np.ndarray | None = None     # (steps_per_round,)


class BatchedEngine:
    """Vectorized flow-plan simulator over ``(step, node)`` tensors,
    with its rate-dependent core on ``device`` (``"cuda"`` unless the
    caller asks for the CPU, where the DCQCN scan takes its plain
    version).

    ``timing`` holds the last :meth:`traces` call's split of wall time
    between the host draw pass and the device core.
    """

    def __init__(self, params: SimParams | None = None, *,
                 device: str = "cuda", plan=None, recorder=None):
        self.p = params or SimParams()
        self.device = resolve_device(device)
        if plan is not None:
            raise _not_ported("a FlowPlan override (plan=)")
        if recorder is not None:
            raise _not_ported("the telemetry TraceRecorder")
        if self.p.topo.hierarchical:
            raise _not_ported(f"a multi-pod topology (n_pods="
                              f"{self.p.topo.n_pods})")
        if self.p.work.schedule != "ring":
            raise _not_ported(f"schedule={self.p.work.schedule!r}")
        if self.p.fault.active:
            raise _not_ported("fault injection (an active FaultParams)")
        self.timing: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _geometry(self, seed: int):
        p = self.p
        net = p.net
        n = net.n_nodes
        plan = schedule_mod.make_plan(net, p.topo, p.work)
        geo = dict(
            n=n, steps=plan.steps_per_round, plan=plan,
            n_pkts=max(1, (p.work.message_bytes // n) // net.mtu_bytes),
            src=np.arange(n), dst=(np.arange(n) + 1) % n,
            n_tors=n // net.nodes_per_tor,
            hier=topology.hier_geometry(net, p.topo))
        master = np.random.default_rng(seed)
        geo["fabric_seed"] = int(master.integers(2**31))
        return geo

    def _new_traces(self, design_list, T, steps, plan, hgs
                    ) -> Dict[str, StepTrace]:
        net, topo = self.p.net, self.p.topo
        return {d: StepTrace(
            design=d, steps_per_round=steps,
            nat_us=np.empty(T), deliv=np.empty(T), total=np.empty(T),
            tier_deliv=np.empty((T, topology.N_TIERS)),
            tier_total=np.empty((T, topology.N_TIERS)),
            tier_counts=plan.tier_counts(net, topo, hgs),
            tier_pkts_round=plan.tier_pkts_round(net, topo, hgs),
            step_priority=plan.step_priority()) for d in design_list}

    def traces(self, design_list: Sequence[str], n_rounds: int, seed: int, *,
               legacy_streams: bool = False,
               per_node_for: Sequence[str] = (),
               round_block: int | None = None) -> Dict[str, StepTrace]:
        """One physics pass for every design in ``design_list``, in the
        shared-fabric mode (the numpy engine's ``legacy_streams=False``;
        unlike the numpy engine, that is the default here, and ``True``
        raises)."""
        if legacy_streams:
            raise _not_ported("legacy_streams=True (replay.py, "
                              "network.roce_fabric_trace)")
        if per_node_for:
            raise _not_ported("per_node_for (per-flow (T, n) traces)")
        from repro_torch.core.transport import engine_torch
        return engine_torch.traces_batched(
            self, list(design_list), n_rounds, [seed],
            round_block=round_block)[0]

    # ------------------------------------------------------------------
    def assemble(self, trace: StepTrace, seed: int, *,
                 celeris_timeout_us: float | None = None,
                 adaptive: bool = True,
                 window: "str | WindowPolicy" = "round",
                 cut_order: str = "arrival") -> RoundStats:
        """Apply round structure (and, for Celeris, bounded windows) to a
        step trace.  Sequential only across rounds, and only when the
        adaptive controller is on.

        ``window``: ``"round"`` is one deadline per round; ``"phase"``
        splits it across the plan's phases, which on the single-phase
        ring is the same ``[1.0]`` split, so the two agree bit for bit.
        ``cut_order``: ``"arrival"`` truncates the trailing steps.
        """
        window = WindowPolicy.parse(window).kind
        if cut_order not in ("arrival", "priority"):
            raise ValueError(f"cut_order must be 'arrival' or "
                             f"'priority', got {cut_order!r}")
        if cut_order == "priority":
            raise _not_ported("cut_order='priority'")
        if window == "step":
            raise _not_ported("window='step'")
        steps = trace.steps_per_round
        R = trace.nat_us.shape[0] // steps
        nat = trace.nat_us.reshape(R, steps)
        deliv = trace.deliv.reshape(R, steps)
        total = trace.total.reshape(R, steps)
        tot_sum = np.maximum(total.sum(axis=1), 1.0)

        # accounting groups riding the window cut: tiers, then priority
        # classes (the step's own split of its delivered packets)
        groups = []             # (R, steps, G) delivered/total pairs
        has_tiers = trace.tier_deliv is not None
        if has_tiers:
            groups.append((trace.tier_deliv.reshape(R, steps, -1),
                           trace.tier_total.reshape(R, steps, -1)))
        prio_pkts = None
        has_prio = trace.step_priority is not None
        if has_prio:
            cls = np.asarray(trace.step_priority, dtype=int)
            onehot = cls[:, None] == np.arange(cls.max() + 1)[None, :]
            pr_total = total[:, :, None] * onehot
            groups.append((deliv[:, :, None] * onehot, pr_total))
            prio_pkts = pr_total.sum(axis=1)[0]

        def _pack(times, fracs, group_fracs):
            gf = list(group_fracs)
            return RoundStats(
                times_us=times, recv_frac=fracs, design=trace.design,
                tier_recv_frac=gf.pop(0) if has_tiers else None,
                prio_recv_frac=gf.pop(0) if has_prio else None,
                tier_counts=trace.tier_counts,
                tier_pkts=trace.tier_pkts_round, prio_pkts=prio_pkts)

        if trace.design != "celeris":
            return _pack(nat.sum(axis=1), deliv.sum(axis=1) / tot_sum,
                         [_tier_frac(gd.sum(axis=1), gt.sum(axis=1))
                          for gd, gt in groups])

        init_to = (celeris_timeout_us or 50_000.0) / 1e6
        cfg = timeout_mod.TimeoutConfig(
            init_timeout=init_to, min_timeout=init_to * 0.25,
            max_timeout=init_to * 8.0, alpha=0.25)
        if not adaptive:
            return _pack(*self._assemble_round_window_fixed(
                nat, deliv, tot_sum, init_to * 1e6, groups))

        rng = np.random.default_rng([seed, _STREAM_WINDOW])
        n = self.p.net.n_nodes
        timeout = cfg.init_timeout
        smoothed = np.full(n, cfg.init_timeout)
        times = np.zeros(R)
        fracs = np.ones(R)
        g_fracs = [np.ones((R, gd.shape[2])) for gd, _ in groups]
        g_tot = [gt.sum(axis=1) for _, gt in groups]
        for r in range(R):
            times[r], got, gots = _cut_block(
                nat[r], deliv[r], timeout * 1e6, [gd[r] for gd, _ in groups])
            fracs[r] = got / tot_sum[r]
            for i, gg in enumerate(gots):
                g_fracs[i][r] = _tier_frac(gg, g_tot[i][r])
            node_frac = np.clip(fracs[r] + rng.normal(0, 0.002, n), 0.0, 1.0)
            local, smoothed = timeout_mod.update_array(
                smoothed, times[r] / 1e6, node_frac, cfg)
            timeout = timeout_mod.adopt_scalar(
                timeout_mod.coordinate(local), cfg)
        return _pack(times, fracs, g_fracs)

    @staticmethod
    def _assemble_round_window_fixed(nat, deliv, tot_sum, budget_us,
                                     groups=()):
        """Fixed bounded round window, all rounds at once (paper
        protocol).  Returns ``(times, fracs, group_fracs)``."""
        cum = np.cumsum(nat, axis=1)
        total_t = cum[:, -1]
        over = total_t > budget_us
        times = np.where(over, budget_us, total_t)
        done = cum <= budget_us
        bidx = np.argmax(~done, axis=1)
        prev = np.where(
            bidx > 0,
            np.take_along_axis(cum, np.maximum(bidx - 1, 0)[:, None],
                               axis=1)[:, 0],
            0.0)
        part = (budget_us - prev) / np.maximum(
            np.take_along_axis(nat, bidx[:, None], axis=1)[:, 0], 1e-9)
        got = ((deliv * done).sum(axis=1)
               + np.take_along_axis(deliv, bidx[:, None], axis=1)[:, 0] * part)
        fracs = np.where(over, got / tot_sum, deliv.sum(axis=1) / tot_sum)
        g_fracs = []
        for g_deliv, g_total in groups:
            # same window cut, applied per group column (the truncated
            # step's partial credit splits in proportion to each
            # column's share of that step's delivered packets)
            R = g_deliv.shape[0]
            got_g = ((g_deliv * done[:, :, None]).sum(axis=1)
                     + g_deliv[np.arange(R), bidx] * part[:, None])
            g_fracs.append(_tier_frac(
                np.where(over[:, None], got_g, g_deliv.sum(axis=1)),
                g_total.sum(axis=1)))
        return times, fracs, g_fracs

    # ------------------------------------------------------------------
    def run(self, design: str, n_rounds: int = 400, *,
            celeris_timeout_us: float | None = None,
            adaptive: bool = True, window: "str | WindowPolicy" = "round",
            cut_order: str = "arrival", seed: int | None = None,
            legacy_streams: bool = False) -> RoundStats:
        """Simulate ``n_rounds`` AllReduce rounds for one NIC design.

        The engine is engine-native by construction, so
        ``legacy_streams`` is turned off here, as the numpy engine's jax
        backend does."""
        seed = self.p.seed if seed is None else seed
        del legacy_streams
        tr = self.traces([design], n_rounds, seed)
        return self.assemble(tr[design], seed,
                             celeris_timeout_us=celeris_timeout_us,
                             adaptive=adaptive, window=window,
                             cut_order=cut_order)

    def paper_protocol(self, n_rounds: int = 400, seed: int = 0, *,
                       legacy_streams: bool = False
                       ) -> Dict[str, RoundStats]:
        """The paper's Fig.-2 protocol: RoCE baseline fixes the Celeris
        window at median + 1 sigma; every design shares one physics
        pass (the shared-fabric mode; ``legacy_streams=True`` raises)."""
        tr = self.traces(designs.DESIGNS, n_rounds, seed,
                         legacy_streams=legacy_streams)
        out = {d: self.assemble(tr[d], seed)
               for d in ("roce", "irn", "srnic")}
        base = out["roce"]
        to = float(np.percentile(base.times_us, 50) + base.times_us.std())
        out["celeris"] = self.assemble(tr["celeris"], seed,
                                       celeris_timeout_us=to,
                                       adaptive=False, window="round")
        return out


def _sparse_path_curves(net, occ_tor: np.ndarray, src: np.ndarray,
                        dst: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact f64 (ecn, drop, hot_rows) per (step, node), touching only
    hot steps.

    Both curves are exactly 0 below their occupancy thresholds, and a
    path's occupancy is the max of its two ToR occupancies (or idle), so
    steps where no ToR crosses the ECN threshold (the lower of the two)
    contribute exact zeros.  ``hot_rows`` are the step indices that were
    actually evaluated.
    """
    T = occ_tor.shape[0]
    n = src.shape[0]
    ecn = np.zeros((T, n))
    drop = np.zeros((T, n))
    rows = np.flatnonzero((occ_tor > net.ecn_threshold).any(axis=1))
    if rows.size:
        op = network.path_occupancy_trace(net, occ_tor[rows], src, dst)
        ecn[rows] = network.ecn_mark_prob(net, op)
        drop[rows] = network.drop_prob(net, op)
    return ecn, drop, rows
