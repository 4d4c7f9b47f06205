"""Batched transport engine (port of ``repro/core/transport/engine.py``).

The engine materializes the simulation as ``(step, flow)`` blocks:
``step`` is the flattened ``round * step`` time axis of a flow plan (the
collective schedule's, ``schedule.make_plan``: the flat ring, or the
``hier`` and ``perrail`` schedules' ``rs``/``dci``/``ag`` phases; or an
arbitrary one passed as ``plan=``, such as the serve path's incast KV
plan, ``serve/traffic.py``), ``flow`` a phase's concurrent flows.  Two
stream modes, as in the numpy engine:

- **legacy streams** (``legacy_streams=True``, the default of
  :meth:`BatchedEngine.traces`, :meth:`~BatchedEngine.run` and
  :meth:`~BatchedEngine.paper_protocol`): the sequential simulator's
  seeded streams replayed on the flat ring (``replay``,
  ``network.roce_fabric_trace``): one clean fabric trace for
  irn/srnic/celeris and RoCE's PFC-polluted one, the selective-repeat
  and celeris draws bit for bit, and one DCQCN pass over the stacked
  CNP channels.  Memory is O(T * n): meant for <= 256 nodes.  This is
  the mode of the committed Fig.-2 numbers;
- **shared fabric** (``legacy_streams=False``, the default of
  :func:`sweep`): work proceeds in round blocks sized to a fixed
  element budget, all NIC designs of one seed share one fabric trace
  and one DCQCN rate trace.  On a multi-pod fabric (``n_pods > 1``)
  the DCI tier overlays the cross-pod flows (``topology``); an active
  ``FaultParams`` adds the seeded stall, crash, flap, rail and
  straggler processes (``faults``).  A plan override runs in this mode
  only; its incast flows (several senders into one receiver) get the
  receiver-port overlay, with its own CNP stream.

Where the work runs (``engine_torch`` has the details):

- the host pass replays the numpy engine's random streams with numpy
  generators in its exact order (shared fabric: block for block and
  phase by phase, fabric and DCI occupancy, path curves, CNP draws,
  fault masks, PFC and loss draws; legacy: the two fabric traces, the
  replayed draws and RoCE's CNP and transfer draws);
- the device core runs the rate-dependent physics as torch ops on
  ``device``: the DCQCN recurrence in one hand-written CUDA kernel call
  (``kernels/csrc/dcqcn.cu``) per block (shared fabric, seeds batched)
  or over the whole trace's stacked CNP channels (legacy), then the
  response curves, the DCI overlay, the fault reactions, per-design
  completion times and the per-step reductions;
- the round assembly (:meth:`BatchedEngine.assemble`: round, phase or
  per-step windows, fixed or adaptive, the cut in arrival or priority
  order) runs on the host over the reduced step traces, and for the
  per-step window over the per-flow ``(T, n)`` arrays the core copies
  back for the designs in ``per_node_for``; :func:`sweep` runs a grid of
  cells, each cell's seeds in one batched pass;
- an opt-in flight recorder (``recorder=``, ``telemetry.TraceRecorder``)
  rides the shared-fabric pass: the core reduces the component tensors
  it already computes per step and tier on the device, and the host
  writes them into the recorder; recording only reads.

The reference is the numpy engine in the same stream mode: the same
host draws, so delivered packets and faulted-flow counts are exact, and
times and fractions agree within rtol 1e-5 (the device core regroups a
few float accumulations, as ``engine_jax`` does).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import timeout as timeout_mod
from repro_torch.core.transport import designs, network, topology
from repro_torch.core.transport import schedule as schedule_mod
from repro_torch.core.transport.params import (FaultParams, SimParams,
                                               WindowPolicy)

# Engine-native random sub-streams, all derived from the user seed
# (the numpy engine's ids: the port must consume the same streams).
# irn and srnic intentionally share one transfer stream.
_STREAM_CNP = 101          # clean-trace CNP draws (shared by designs)
_STREAM_CNP_ROCE = 102     # RoCE's CNP draws on its hot rows (legacy mode)
_STREAM_PFC = 103          # PFC cascade draws (shared-fabric mode only)
_STREAM_TRANSFER = {"roce": 110, "irn": 111, "srnic": 111, "celeris": 112}
_STREAM_WINDOW = 120       # bounded-window controller observation noise
_STREAM_INCAST_CNP = 150   # CNP draws on incast (fan_in > 1) flow columns

# Round-block sizing: bound the (step, node) chunk to this many elements
# so peak memory is flat in cluster size.  Not a tuning knob: the host
# pass must consume the streams in the numpy engine's block partition.
_BLOCK_ELEMENTS = 4 << 20


def _tier_frac(got: np.ndarray, tot: np.ndarray) -> np.ndarray:
    """Delivered fraction per tier; empty tiers report 1 (nothing to
    lose)."""
    return np.where(tot > 0, got / np.maximum(tot, 1.0), 1.0)


def _cut_block(nat_b, deliv_b, budget_us, groups, perm=None):
    """Apply one deadline to a contiguous run of steps.

    Elapsed time is ``min(sum(nat), budget)``; packets delivered strictly
    inside the deadline count in full and the boundary step earns linear
    partial credit.  ``groups`` are (steps, G) per-group delivered
    arrays (tiers, pods, priority classes) that take the same cut.
    Returns ``(elapsed, got, group_gots)``.

    ``perm`` (``cut_order="priority"``) reallocates the same total cut
    across steps in a static order (lowest priority class first, late
    arrivals first within a class), so elapsed time and total delivered
    packets are unchanged while the per-group accounting concentrates
    the loss in the low-priority steps.  ``perm=None`` is arrival order.
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
    if perm is not None:
        survive = _priority_survive(deliv_b[None, :],
                                    np.array([deliv_b.sum() - got]),
                                    perm)[0]
        return budget_us, got, [(g * survive[:, None]).sum(0)
                                for g in groups]
    return budget_us, got, [(g * done[:, None]).sum(0) + g[bidx] * part
                            for g in groups]


def _priority_survive(d, K, perm):
    """(R, steps) per-step survive fraction cutting ``K`` packets in
    ``perm`` order: walk the steps in that order and remove delivered
    packets until the arrival cut's total ``K[r]`` is gone; the boundary
    step takes a linear partial cut.  With uniform priorities ``perm``
    is reverse arrival order and the allocation is the arrival cut's."""
    d_perm = d[:, perm]
    cum = np.cumsum(d_perm, axis=1)
    prev = cum - d_perm
    cutfrac = np.clip((K[:, None] - prev) / np.maximum(d_perm, 1e-30),
                      0.0, 1.0)
    survive = np.empty_like(d)
    survive[:, perm] = 1.0 - cutfrac
    return survive


def _priority_perm(step_priority: np.ndarray) -> np.ndarray:
    """Static cut order over a step block: priority class ascending
    (lowest cut first), step index descending within a class (so
    uniform-priority blocks reproduce the arrival cut's allocation)."""
    idx = np.arange(step_priority.size)
    return np.lexsort((-idx, step_priority))


@dataclasses.dataclass
class RoundStats:
    times_us: np.ndarray          # (rounds,)
    recv_frac: np.ndarray         # (rounds,) delivered fraction of payload
    design: str
    # per-tier delivered fractions (topology.TIERS order)
    tier_recv_frac: np.ndarray | None = None    # (rounds, n_tiers)
    tier_counts: np.ndarray | None = None       # (n_tiers,) flows per tier
    tier_pkts: np.ndarray | None = None         # (n_tiers,) offered/round
    # per-pod intra fractions and offered intra packets per round per pod
    # (multi-pod fabrics only)
    pod_recv_frac: np.ndarray | None = None     # (rounds, n_pods)
    pod_pkts: np.ndarray | None = None          # (n_pods,)
    # per-priority-class delivered fractions and offered packets
    prio_recv_frac: np.ndarray | None = None
    prio_pkts: np.ndarray | None = None
    # fault accounting (None on fault-free traces): per round, the steps
    # with >= 1 faulted flow and the faulted (flow, step) cells
    fault_steps: np.ndarray | None = None       # (rounds,)
    affected_flows: np.ndarray | None = None    # (rounds,)

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

    def tier_loss(self, tier: str) -> float:
        """Mean loss on one tier ('tor' | 'spine' | 'dci'); 0 when the
        tier is empty or untracked."""
        if self.tier_recv_frac is None:
            return 0.0
        k = topology.TIERS.index(tier)
        if self.tier_counts is not None and self.tier_counts[k] == 0:
            return 0.0
        return float(1.0 - self.tier_recv_frac[:, k].mean())

    def prio_loss(self, cls: int) -> float:
        """Mean loss in one priority class (0 = lowest, cut first under
        ``cut_order="priority"``); 0 when the class is empty or the
        trace carried no priority metadata."""
        if self.prio_recv_frac is None or cls >= self.prio_recv_frac.shape[1]:
            return 0.0
        if self.prio_pkts is not None and self.prio_pkts[cls] == 0:
            return 0.0
        return float(1.0 - self.prio_recv_frac[:, cls].mean())

    # -- fault-resilience metrics (Fig. 7) ------------------------------
    @property
    def faulted(self) -> np.ndarray:
        """(rounds,) bool: rounds with at least one faulted flow."""
        if self.fault_steps is None:
            return np.zeros(self.times_us.shape[0], dtype=bool)
        return np.asarray(self.fault_steps) > 0

    def goodput_trace(self) -> np.ndarray:
        """(rounds,) delivered payload per unit time, normalized so the
        mean fault-free round is 1.0 (the all-round mean when every round
        was faulted)."""
        g = self.recv_frac / np.maximum(self.times_us, 1e-9)
        clean = ~self.faulted
        ref = g[clean].mean() if clean.any() else g.mean()
        return g / max(float(ref), 1e-30)

    @property
    def goodput_under_failure(self) -> float:
        """The faulted rounds' mean goodput over the clean rounds' (1.0
        on a fault-free trace)."""
        f = self.faulted
        if not f.any():
            return 1.0
        g = self.recv_frac / np.maximum(self.times_us, 1e-9)
        ref = g[~f].mean() if (~f).any() else g.mean()
        return float(g[f].mean() / max(float(ref), 1e-30))

    def recovery_rounds(self, frac: float = 0.9) -> float:
        """Mean rounds from the end of each fault episode until the
        normalized goodput first returns to ``frac``; an episode not
        recovered by the end of the trace counts its remaining length."""
        f = self.faulted
        if not f.any():
            return 0.0
        g = self.goodput_trace()
        ends = np.flatnonzero(f[:-1] & ~f[1:]) + 1   # first clean round
        waits = []
        for e in ends:
            ok = np.flatnonzero(g[e:] >= frac)
            waits.append(float(ok[0]) if ok.size else float(f.size - e))
        return float(np.mean(waits)) if waits else 0.0

    def summary(self) -> Dict[str, float]:
        return dict(p50_us=self.p50, p99_us=self.p99, p999_us=self.p999,
                    mean_us=float(self.times_us.mean()),
                    data_loss=self.mean_loss)


@dataclasses.dataclass
class StepTrace:
    """Reduced per-step physics for one design (full trace length T):
    ``(T,)`` reductions over flows, per-tier ``(T, n_tiers)`` and per-pod
    ``(T, n_pods)`` sums, and the plan facts the window assembly reads.
    The per-node ``(T, n)`` arrays are kept only for the designs a
    per-step window (``window="step"``) must re-inspect flow by flow
    (``traces(per_node_for=)``); a node's cells outside its phases stay
    zero."""
    design: str
    steps_per_round: int
    nat_us: np.ndarray            # max over flows of completion time
    deliv: np.ndarray             # delivered packets summed over flows
    total: np.ndarray             # offered packets summed over flows
    node_time_us: np.ndarray | None = None      # (T, n) per sender node
    node_deliv: np.ndarray | None = None        # (T, n)
    tier_deliv: np.ndarray | None = None
    tier_total: np.ndarray | None = None
    tier_counts: np.ndarray | None = None       # (n_tiers,) flows per tier
    tier_pkts_round: np.ndarray | None = None   # (n_tiers,) offered/round
    phase_of_step: np.ndarray | None = None     # (steps_per_round,)
    phase_budget_frac: np.ndarray | None = None  # (n_phases,) sums to 1
    # per phase: sender nodes, and per-tier and per-pod flow columns
    # (the step window's scatter map)
    phase_src: tuple | None = None
    phase_tier_cols: tuple | None = None
    phase_pod_cols: tuple | None = None
    # (steps_per_round,) priority class per step: assembly-time metadata
    # (the priority cut and the per-class accounting read it)
    step_priority: np.ndarray | None = None
    pod_deliv: np.ndarray | None = None         # multi-pod fabrics only
    pod_total: np.ndarray | None = None
    pod_pkts_round: np.ndarray | None = None    # (n_pods,) offered/round
    fault_flows: np.ndarray | None = None       # (T,) faulted flows a step


class BatchedEngine:
    """Vectorized flow-plan simulator over ``(step, flow)`` tensors, with
    its rate-dependent core on ``device`` (``"cuda"`` unless the caller
    asks for the CPU, where the DCQCN scan takes its plain version).

    Times one :class:`~repro_torch.core.transport.schedule.FlowPlan` per
    round: the collective plan named by ``params.work.schedule``, or the
    ``plan=`` override (shared-fabric mode only).  ``recorder`` (a
    ``telemetry.TraceRecorder``) records the shared-fabric passes' tail
    attribution; it reads the physics and draws nothing, so the stats
    are bit-identical with and without it.

    ``timing`` holds the last :meth:`traces` call's split of wall time
    between the host draw pass and the device core, and the bytes of
    per-node and recorder copies from the card.
    """

    def __init__(self, params: SimParams | None = None, *,
                 device: str = "cuda", plan=None, recorder=None):
        self.p = params or SimParams()
        self.device = resolve_device(device)
        self.plan_override = plan
        self.recorder = recorder
        self.timing: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _geometry(self, seed: int):
        p = self.p
        net = p.net
        n = net.n_nodes
        plan = (self.plan_override if self.plan_override is not None
                else schedule_mod.make_plan(net, p.topo, p.work))
        geo = dict(n=n, steps=plan.steps_per_round, plan=plan,
                   n_tors=n // net.nodes_per_tor)
        master = np.random.default_rng(seed)
        geo["fabric_seed"] = int(master.integers(2**31))
        return geo

    def _new_traces(self, design_list, T, plan, hgs,
                    per_node_for=()) -> Dict[str, StepTrace]:
        net, topo = self.p.net, self.p.topo
        n = net.n_nodes
        pods = topo.n_pods if topo.hierarchical else 0
        return {d: StepTrace(
            design=d, steps_per_round=plan.steps_per_round,
            nat_us=np.empty(T), deliv=np.empty(T), total=np.empty(T),
            # zeroed: multi-phase plans leave a node's idle cells untouched
            node_time_us=np.zeros((T, n)) if d in per_node_for else None,
            node_deliv=np.zeros((T, n)) if d in per_node_for else None,
            tier_deliv=np.empty((T, topology.N_TIERS)),
            tier_total=np.empty((T, topology.N_TIERS)),
            tier_counts=plan.tier_counts(net, topo, hgs),
            tier_pkts_round=plan.tier_pkts_round(net, topo, hgs),
            phase_of_step=plan.phase_of_step,
            phase_budget_frac=plan.budget_fracs(),
            phase_src=tuple(ph.src for ph in plan.phases),
            phase_tier_cols=tuple(hg.tier_cols for hg in hgs),
            phase_pod_cols=(tuple(hg.pod_cols for hg in hgs) if pods
                            else None),
            step_priority=plan.step_priority(),
            pod_deliv=np.zeros((T, pods)) if pods else None,
            pod_total=np.zeros((T, pods)) if pods else None,
            pod_pkts_round=(plan.pod_pkts_round(net, topo, hgs)
                            if pods else None)) for d in design_list}

    def traces(self, design_list: Sequence[str], n_rounds: int, seed: int, *,
               legacy_streams: bool = True,
               per_node_for: Sequence[str] = (),
               round_block: int | None = None) -> Dict[str, StepTrace]:
        """One physics pass for every design in ``design_list``.

        ``legacy_streams=True`` replays the sequential simulator's seeded
        streams on the flat ring (one pass over the whole trace, memory
        O(T * n)); ``False`` is the shared-fabric mode, in round blocks
        (``round_block`` rounds each; the numpy engine's partition by
        default).  Legacy mode refuses what has no sequential stream to
        replay, and a recorder, with the numpy engine's ``ValueError``s.
        The designs in ``per_node_for`` keep their per-flow ``(T, n)``
        times and delivered packets (``StepTrace.node_time_us``,
        ``node_deliv``), which the per-step window needs.
        """
        from repro_torch.core.transport import engine_torch
        if legacy_streams:
            self._check_legacy()
            return engine_torch.traces_legacy(self, list(design_list),
                                              n_rounds, seed,
                                              per_node_for=per_node_for)
        return engine_torch.traces_batched(
            self, list(design_list), n_rounds, [seed],
            round_block=round_block, per_node_for=per_node_for)[0]

    def _check_legacy(self):
        """The numpy engine's refusals of legacy streams: the sequential
        simulator only ever ran the flat, fault-free ring."""
        if self.p.topo.hierarchical:
            raise ValueError(
                "hierarchical topologies (n_pods > 1) require "
                "legacy_streams=False (shared-fabric mode)")
        if self.p.work.schedule != "ring":
            raise ValueError(
                f"schedule={self.p.work.schedule!r} requires "
                "legacy_streams=False (shared-fabric mode)")
        if self.plan_override is not None:
            raise ValueError(
                "a FlowPlan override requires legacy_streams=False "
                "(shared-fabric mode)")
        if self.p.fault.active:
            raise ValueError(
                "fault injection (FaultParams) requires "
                "legacy_streams=False (shared-fabric mode)")
        if self.recorder is not None:
            # the recorder rides the shared-fabric per-phase pass
            raise ValueError(
                "a TraceRecorder requires legacy_streams=False "
                "(shared-fabric mode)")

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
        splits it across the plan's phases by their ``budget_frac``
        weights, each phase block truncated at its own deadline;
        ``"step"`` divides each phase's share uniformly over its steps
        and cuts flow by flow (per-flow data required).  On a
        single-phase plan the split is ``[1.0]``: "phase" is "round" bit
        for bit.  ``cut_order``: ``"arrival"`` truncates the trailing
        steps; ``"priority"`` reallocates the same total cut by the
        steps' priority class, lowest first (round and phase windows
        only): times and total delivered fractions are identical between
        the two orders, only the per-tier, per-pod and per-class
        accounting moves.
        """
        window = WindowPolicy.parse(window).kind
        if cut_order not in ("arrival", "priority"):
            raise ValueError(f"cut_order must be 'arrival' or "
                             f"'priority', got {cut_order!r}")
        if cut_order == "priority":
            if trace.step_priority is None:
                raise ValueError(
                    "cut_order='priority' needs a trace with "
                    "step_priority metadata (engine-built traces carry "
                    "it; traces assembled from raw arrays do not)")
            if window == "step":
                raise ValueError(
                    "cut_order='priority' applies to round/phase "
                    "budgets; the step window binds per step, leaving "
                    "no cut to reorder")
        steps = trace.steps_per_round
        R = trace.nat_us.shape[0] // steps
        nat = trace.nat_us.reshape(R, steps)
        deliv = trace.deliv.reshape(R, steps)
        total = trace.total.reshape(R, steps)
        tot_sum = np.maximum(total.sum(axis=1), 1.0)

        # accounting groups riding the window cut: tiers, then pods,
        # then priority classes (the step's own split of its packets)
        groups = []             # (R, steps, G) delivered/total pairs
        kinds = []
        for kind, gd, gt in (("tier", trace.tier_deliv, trace.tier_total),
                             ("pod", trace.pod_deliv, trace.pod_total)):
            if gd is not None:
                groups.append((gd.reshape(R, steps, -1),
                               gt.reshape(R, steps, -1)))
                kinds.append(kind)
        prio_pkts = None
        if trace.step_priority is not None:
            cls = np.asarray(trace.step_priority, dtype=int)
            onehot = cls[:, None] == np.arange(cls.max() + 1)[None, :]
            pr_total = total[:, :, None] * onehot
            groups.append((deliv[:, :, None] * onehot, pr_total))
            kinds.append("prio")
            prio_pkts = pr_total.sum(axis=1)[0]
        extra = dict(tier_counts=trace.tier_counts,
                     tier_pkts=trace.tier_pkts_round,
                     pod_pkts=trace.pod_pkts_round, prio_pkts=prio_pkts)
        if trace.fault_flows is not None:
            ff = trace.fault_flows.reshape(R, steps)
            extra.update(fault_steps=(ff > 0).sum(axis=1),
                         affected_flows=ff.sum(axis=1))

        def _pack(times, fracs, group_fracs):
            by_kind = dict(zip(kinds, group_fracs))
            st = RoundStats(
                times_us=times, recv_frac=fracs, design=trace.design,
                tier_recv_frac=by_kind.get("tier"),
                pod_recv_frac=by_kind.get("pod"),
                prio_recv_frac=by_kind.get("prio"), **extra)
            if self.recorder is not None:
                # window-cut attribution: the gap between the trace's
                # post-fault delivery and what survived the window
                self.recorder.record_assemble(trace, st)
            return st

        if trace.design != "celeris":
            return _pack(nat.sum(axis=1), deliv.sum(axis=1) / tot_sum,
                         [_tier_frac(gd.sum(axis=1), gt.sum(axis=1))
                          for gd, gt in groups])

        if window == "step" and trace.node_time_us is None:
            raise ValueError(
                "window='step' needs per-flow data: build the trace with "
                "traces(..., per_node_for=('celeris',)) or use "
                "BatchedEngine.run(), which sets it up")
        # per-phase structure; a trace without plan metadata is one phase
        # covering the round
        if trace.phase_of_step is not None:
            ph_rows = [np.flatnonzero(trace.phase_of_step == k)
                       for k in range(trace.phase_budget_frac.size)]
            ph_frac = trace.phase_budget_frac
        else:
            ph_rows, ph_frac = [np.arange(steps)], np.ones(1)
        step_round = None
        if window == "step":
            step_round = self._step_window(trace, ph_rows, ph_frac, kinds,
                                           groups)

        # budget blocks: the whole round, or each phase's steps with its
        # share of the budget; with the priority cut, each block's static
        # cut order
        sp = (np.asarray(trace.step_priority, dtype=int)
              if cut_order == "priority" else None)
        if window == "phase":
            blocks = list(zip(ph_rows, ph_frac))
        else:
            blocks = [(np.arange(steps), 1.0)]
        blocks = [(rows, frac, None if sp is None else _priority_perm(sp[rows]))
                  for rows, frac in blocks]

        init_to = (celeris_timeout_us or 50_000.0) / 1e6
        cfg = timeout_mod.TimeoutConfig(
            init_timeout=init_to, min_timeout=init_to * 0.25,
            max_timeout=init_to * 8.0, alpha=0.25)
        if not adaptive and step_round is None:
            return _pack(*self._assemble_window_fixed(
                nat, deliv, tot_sum, init_to * 1e6, groups, blocks))

        rng = np.random.default_rng([seed, _STREAM_WINDOW])
        n = self.p.net.n_nodes
        timeout = cfg.init_timeout
        smoothed = np.full(n, cfg.init_timeout)
        times = np.zeros(R)
        fracs = np.ones(R)
        g_fracs = [np.ones((R, gd.shape[2])) for gd, _ in groups]
        g_tot = [gt.sum(axis=1) for _, gt in groups]
        for r in range(R):
            budget_us = timeout * 1e6
            if step_round is not None:
                times[r], got, gots = step_round(r, budget_us)
            else:
                t_sum, got = 0.0, 0.0
                gots = [np.zeros(gd.shape[2]) for gd, _ in groups]
                for rows, frac, perm in blocks:
                    t_k, got_k, gots_k = _cut_block(
                        nat[r, rows], deliv[r, rows], budget_us * frac,
                        [gd[r, rows] for gd, _ in groups], perm=perm)
                    t_sum += t_k
                    got += got_k
                    for gg, gk in zip(gots, gots_k):
                        gg += gk
                times[r] = t_sum
            fracs[r] = got / tot_sum[r]
            for i, gg in enumerate(gots):
                g_fracs[i][r] = _tier_frac(gg, g_tot[i][r])
            if adaptive:
                node_frac = np.clip(fracs[r] + rng.normal(0, 0.002, n),
                                    0.0, 1.0)
                local, smoothed = timeout_mod.update_array(
                    smoothed, times[r] / 1e6, node_frac, cfg)
                timeout = timeout_mod.adopt_scalar(
                    timeout_mod.coordinate(local), cfg)
        return _pack(times, fracs, g_fracs)

    @staticmethod
    def _step_window(trace: StepTrace, ph_rows, ph_frac, kinds, groups):
        """The per-step window's round function ``(r, budget_us) ->
        (elapsed, got, group_gots)``: each phase's budget share divided
        uniformly over its steps, each flow cut by how late it is, and
        the survivors scattered per tier, per pod and per class.  Raises
        the numpy engine's ``ValueError`` where a map is missing."""
        steps = trace.steps_per_round
        nat = trace.nat_us.reshape(-1, steps)
        ph_src = trace.phase_src if trace.phase_of_step is not None else None
        if len(ph_rows) > 1 and ph_src is None:
            raise ValueError(
                "window='step' on a multi-phase plan needs the trace's "
                "per-phase sender maps (engine-built traces carry them)")
        # per-group column maps, aligned one-to-one with ``groups``
        step_col_maps = []
        for kind, ph_cols, what in (
                ("tier", trace.phase_tier_cols, "flow→tier"),
                ("pod", trace.phase_pod_cols, "flow→pod")):
            if kind not in kinds:
                continue
            if ph_cols is None:
                raise ValueError(
                    f"window='step' {what} accounting needs the plan's "
                    "per-phase flow maps (engine-built traces carry "
                    "them)")
            step_col_maps.append(ph_cols)
        n_prio = groups[kinds.index("prio")][0].shape[2] if (
            "prio" in kinds) else 0

        def _node_cols(k, cols):
            # a phase's flow columns → node columns in the (T, n) arrays
            return cols if ph_src is None else ph_src[k][cols]

        def round_fn(r, budget_us):
            step_to = np.empty(steps)
            for k, rows in enumerate(ph_rows):
                step_to[rows] = budget_us * ph_frac[k] / rows.size
            t_node = trace.node_time_us[r * steps: (r + 1) * steps]
            d_node = trace.node_deliv[r * steps: (r + 1) * steps]
            late = np.clip((t_node - step_to[:, None])
                           / np.maximum(t_node, 1e-9), 0, 1)
            time_r = np.minimum(nat[r], step_to).sum()
            got_node = d_node * (1 - late)
            gots = []
            for ph_cols in step_col_maps:
                got_g = np.zeros(len(ph_cols[0]))
                for k, rows in enumerate(ph_rows):
                    for j, cols in enumerate(ph_cols[k]):
                        if cols.size:
                            got_g[j] += got_node[
                                np.ix_(rows, _node_cols(k, cols))].sum()
                gots.append(got_g)
            if n_prio:
                # each step's survivors land whole in that step's class
                got_pr = np.zeros(n_prio)
                np.add.at(got_pr, np.asarray(trace.step_priority, int),
                          got_node.sum(axis=1))
                gots.append(got_pr)
            return time_r, got_node.sum(), gots

        return round_fn

    @staticmethod
    def _assemble_window_fixed(nat, deliv, tot_sum, budget_us, groups,
                               blocks):
        """Fixed bounded windows, all rounds at once (paper protocol):
        each budget block of steps (the whole round, or one phase) takes
        its share of the budget and is truncated at its own deadline;
        a block's priority permutation (or None: arrival order) decides
        which steps the group accounting charges the cut to.  Returns
        ``(times, fracs, group_fracs)``."""
        R = nat.shape[0]
        times = np.zeros(R)
        got = np.zeros(R)
        got_g = [np.zeros((R, gd.shape[2])) for gd, _ in groups]
        for rows, frac, perm in blocks:
            b_k = budget_us * frac
            cum = np.cumsum(nat[:, rows], axis=1)
            total_t = cum[:, -1]
            over = total_t > b_k
            times += np.where(over, b_k, total_t)
            done = cum <= b_k
            bidx = np.argmax(~done, axis=1)
            prev = np.where(
                bidx > 0,
                np.take_along_axis(cum, np.maximum(bidx - 1, 0)[:, None],
                                   axis=1)[:, 0],
                0.0)
            d_k = deliv[:, rows]
            part = (b_k - prev) / np.maximum(
                np.take_along_axis(nat[:, rows], bidx[:, None],
                                   axis=1)[:, 0], 1e-9)
            got_k = ((d_k * done).sum(axis=1)
                     + np.take_along_axis(d_k, bidx[:, None],
                                          axis=1)[:, 0] * part)
            got += np.where(over, got_k, d_k.sum(axis=1))
            survive = None
            if perm is not None:
                K = np.where(over, d_k.sum(axis=1) - got_k, 0.0)
                survive = _priority_survive(d_k, K, perm)
            for i, (gd, _) in enumerate(groups):
                # the truncated step's partial credit splits in
                # proportion to each column's share of its packets
                gd_k = gd[:, rows]
                if survive is not None:
                    cut = (gd_k * survive[:, :, None]).sum(axis=1)
                else:
                    cut = ((gd_k * done[:, :, None]).sum(axis=1)
                           + gd_k[np.arange(R), bidx] * part[:, None])
                got_g[i] += np.where(over[:, None], cut, gd_k.sum(axis=1))
        fracs = got / tot_sum
        g_fracs = [_tier_frac(gg, gt.sum(axis=1))
                   for gg, (_, gt) in zip(got_g, groups)]
        return times, fracs, g_fracs

    # ------------------------------------------------------------------
    def run(self, design: str, n_rounds: int = 400, *,
            celeris_timeout_us: float | None = None,
            adaptive: bool = True, window: "str | WindowPolicy" = "round",
            cut_order: str = "arrival", seed: int | None = None,
            legacy_streams: bool = True) -> RoundStats:
        """Simulate ``n_rounds`` rounds for one NIC design.

        ``legacy_streams`` follows the numpy engine's rules: adaptive
        Celeris (its controller's draws are not replayable), non-ring
        schedules, plan overrides and active faults (no sequential
        stream to replay) and a recorder (it rides the shared-fabric
        pass) run in the shared-fabric mode; a multi-pod ring raises.
        The per-step window keeps Celeris's per-flow arrays."""
        seed = self.p.seed if seed is None else seed
        window = WindowPolicy.parse(window).kind
        keep = (design,) if design == "celeris" and window == "step" else ()
        if ((design == "celeris" and adaptive)
                or self.p.work.schedule != "ring" or self.p.fault.active
                or self.plan_override is not None
                or self.recorder is not None):
            legacy_streams = False
        tr = self.traces([design], n_rounds, seed,
                         legacy_streams=legacy_streams, per_node_for=keep)
        return self.assemble(tr[design], seed,
                             celeris_timeout_us=celeris_timeout_us,
                             adaptive=adaptive, window=window,
                             cut_order=cut_order)

    def paper_protocol(self, n_rounds: int = 400, seed: int = 0, *,
                       legacy_streams: bool = True
                       ) -> Dict[str, RoundStats]:
        """The paper's Fig.-2 protocol: RoCE baseline fixes the Celeris
        window at median + 1 sigma; every design shares one physics
        pass."""
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


# ----------------------------------------------------------------------
# Parameter-sweep API
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedSimParams:
    """A sweep grid over the batched engine.

    Celeris windows follow the paper protocol per (config, seed): the
    seed's RoCE median + 1 sigma times ``timeout_scale``, unless
    ``celeris_timeout_us`` pins them.  ``n_pods`` adds the
    hierarchical-topology dimension (``base.topo`` configures the DCI
    tier), ``schedules`` the collective schedule ("ring" | "hier" |
    "perrail"), ``windows`` the Celeris window policy ("round" |
    "phase"; assembled from one trace per cell) and ``faults`` the
    failure scenario (``FaultParams``, ``"kind:rate"`` specs or None for
    the fault-free cell; each scenario runs its own trace).  The JAX
    package's ``backend`` switch has no counterpart: :func:`sweep` takes
    a ``device``.  ``legacy_streams=True`` replays each seed's
    sequential streams (flat, fault-free ring cells only).
    """
    n_nodes: Sequence[int] = (128,)
    message_mb: Sequence[float] = (25.0,)
    seeds: Sequence[int] = (0,)
    n_pods: Sequence[int] = (1,)
    schedules: Sequence[str] = ("ring",)
    windows: Sequence[str] = ("round",)
    faults: Sequence = (None,)
    designs: Sequence[str] = designs.DESIGNS
    n_rounds: int = 200
    celeris_timeout_us: float | None = None
    timeout_scale: float = 1.0
    legacy_streams: bool = False      # sweeps share one fabric trace
    base: SimParams = SimParams()

    def fault_params(self) -> tuple:
        """``faults`` normalized to FaultParams (None => inactive)."""
        return tuple(FaultParams() if f is None else FaultParams.parse(f)
                     for f in self.faults)


@dataclasses.dataclass
class SweepResult:
    """``stats[(design, n_nodes, message_mb, seed)] -> RoundStats``.

    Keys grow a trailing element for each axis the grid sweeps, in this
    order: pod count (``n_pods != (1,)``), schedule (``schedules !=
    ("ring",)``), window (``windows != ("round",)``) and the fault's
    ``FaultParams.tag`` (``faults != (None,)``).  ``timing`` holds each
    cell's engine pass split (``BatchedEngine.timing``), keyed by
    ``(n_nodes, message_mb, n_pods, schedule, fault tag)``.
    """
    params: BatchedSimParams
    stats: Dict[tuple, RoundStats]
    timing: Dict[tuple, dict] = dataclasses.field(default_factory=dict)

    def fault_tags(self) -> tuple:
        return tuple(fp.tag for fp in self.params.fault_params())

    def _key(self, d, nn, mb, s, npods, sched="ring", window="round",
             fault="none"):
        key = (d, nn, mb, s)
        if tuple(self.params.n_pods) != (1,):
            key += (npods,)
        if tuple(self.params.schedules) != ("ring",):
            key += (sched,)
        if tuple(self.params.windows) != ("round",):
            key += (window,)
        if self.fault_tags() != ("none",):
            key += (fault,)
        return key

    def _p99_over(self, design, axis, values, **fixed):
        """{value: (mean p99 over seeds, std)} along one grid axis, the
        others at ``fixed`` or their first grid value."""
        p = self.params
        cell = dict(nn=p.n_nodes[0], mb=p.message_mb[0], npods=p.n_pods[0],
                    sched=p.schedules[0], window=p.windows[0])
        cell.update({k: v for k, v in fixed.items() if v is not None})
        out = {}
        for v in values:
            c = dict(cell, **{axis: v})
            ps = [self.stats[self._key(design, c["nn"], c["mb"], s,
                                       c["npods"], c["sched"],
                                       c["window"])].p99
                  for s in p.seeds]
            out[v] = (float(np.mean(ps)), float(np.std(ps)))
        return out

    def p99_vs_scale(self, design: str, message_mb: float | None = None,
                     n_pods: int | None = None, schedule: str | None = None,
                     window: str | None = None):
        """{n_nodes: (mean p99 over seeds, std over seeds)}."""
        return self._p99_over(design, "nn", self.params.n_nodes,
                              mb=message_mb, npods=n_pods, sched=schedule,
                              window=window)

    def p99_vs_pods(self, design: str, n_nodes: int | None = None,
                    message_mb: float | None = None,
                    schedule: str | None = None, window: str | None = None):
        """{n_pods: (mean p99 over seeds, std over seeds)}."""
        return self._p99_over(design, "npods", self.params.n_pods,
                              nn=n_nodes, mb=message_mb, sched=schedule,
                              window=window)

    def p99_vs_schedule(self, design: str, n_nodes: int | None = None,
                        message_mb: float | None = None,
                        n_pods: int | None = None,
                        window: str | None = None):
        """{schedule: (mean p99 over seeds, std over seeds)}."""
        return self._p99_over(design, "sched", self.params.schedules,
                              nn=n_nodes, mb=message_mb, npods=n_pods,
                              window=window)

    def p99_vs_window(self, design: str, n_nodes: int | None = None,
                      message_mb: float | None = None,
                      n_pods: int | None = None,
                      schedule: str | None = None):
        """{window: (mean p99 over seeds, std over seeds)}: one physics
        trace, different budget assembly."""
        return self._p99_over(design, "window", self.params.windows,
                              nn=n_nodes, mb=message_mb, npods=n_pods,
                              sched=schedule)

    def summary_rows(self):
        """Flat (key..., p50, p99, loss) rows."""
        return [key + (st.p50, st.p99, st.mean_loss)
                for key, st in sorted(self.stats.items())]


def sweep(params: BatchedSimParams | None = None, *, progress=None,
          device: str = "cuda") -> SweepResult:
    """Run the grid in :class:`BatchedSimParams` on ``device``: one
    batched engine pass (every seed at once) per ``(n_nodes, message_mb,
    n_pods, schedule, fault)`` cell, every design and window policy
    assembled from that cell's traces (with ``legacy_streams``, one
    legacy pass per seed).  Keys follow :class:`SweepResult`.
    ``progress``: optional ``callable(str)`` for liveness logging."""
    from repro_torch.core.transport import engine_torch
    bp = params or BatchedSimParams()
    if bp.legacy_streams and any(np_ > 1 for np_ in bp.n_pods):
        raise ValueError("legacy_streams=True is incompatible with "
                         "n_pods > 1 sweep cells")
    if bp.legacy_streams and any(sc != "ring" for sc in bp.schedules):
        raise ValueError("legacy_streams=True is incompatible with "
                         "non-ring schedule sweep cells")
    fault_grid = bp.fault_params()
    if bp.legacy_streams and any(fp.active for fp in fault_grid):
        raise ValueError("legacy_streams=True is incompatible with "
                         "fault-injection sweep cells")
    for win in bp.windows:
        if WindowPolicy.parse(win).kind == "step":
            # the per-step window needs per-flow (T, n) arrays the
            # sweep never materializes (memory flat in cluster size)
            raise ValueError("sweep windows must be 'round' or 'phase' "
                             "(window='step' needs per-flow traces; use "
                             "BatchedEngine.run)")
    device = resolve_device(device)
    res = SweepResult(params=bp, stats={})
    total_cells = (len(bp.n_nodes) * len(bp.message_mb) * len(bp.n_pods)
                   * len(bp.schedules) * len(fault_grid))
    done_cells = 0
    t0 = time.perf_counter()
    for nn in bp.n_nodes:
        for mb in bp.message_mb:
            for npods in bp.n_pods:
                for sched in bp.schedules:
                    for fp in fault_grid:
                        if progress is not None:
                            progress(f"[{device.type}] n_nodes={nn} "
                                     f"message_mb={mb} n_pods={npods} "
                                     f"schedule={sched} fault={fp.tag} "
                                     f"seeds={list(bp.seeds)} ({done_cells}/"
                                     f"{total_cells} cells, "
                                     f"{time.perf_counter() - t0:.1f} s)")
                        p = dataclasses.replace(
                            bp.base,
                            net=dataclasses.replace(bp.base.net, n_nodes=nn),
                            work=dataclasses.replace(
                                bp.base.work, message_bytes=int(mb * 2**20),
                                schedule=sched),
                            topo=dataclasses.replace(bp.base.topo,
                                                     n_pods=npods),
                            fault=fp)
                        eng = BatchedEngine(p, device=str(device))
                        if bp.legacy_streams:
                            trs, split = [], []
                            for s in bp.seeds:
                                trs.append(eng.traces(list(bp.designs),
                                                      bp.n_rounds, s))
                                split.append(eng.timing)
                            timing = dict(split[-1], seeds=len(split), **{
                                k: sum(t[k] for t in split)
                                for k in ("host_s", "device_s", "blocks")})
                        else:
                            trs = engine_torch.traces_batched(
                                eng, list(bp.designs), bp.n_rounds,
                                list(bp.seeds))
                            timing = eng.timing
                        res.timing[(nn, mb, npods, sched, fp.tag)] = timing
                        for s, tr in zip(bp.seeds, trs):
                            _assemble_cell(res, eng, bp, tr, s,
                                           (nn, mb, npods, sched), fp.tag)
                        done_cells += 1
    return res


def _assemble_cell(res, eng, bp, tr, s, cell, fault_tag):
    """One seed of one sweep cell: every design, every window."""
    nn, mb, npods, sched = cell
    to = bp.celeris_timeout_us
    if "celeris" in bp.designs and to is None:
        if "roce" in bp.designs:
            base = eng.assemble(tr["roce"], s)
            to = float((np.percentile(base.times_us, 50)
                        + base.times_us.std()) * bp.timeout_scale)
        else:
            to = 50_000.0 * bp.timeout_scale
    for d in bp.designs:
        # window policies share the physics trace: only the celeris
        # budget assembly differs
        st = None if d == "celeris" else eng.assemble(tr[d], s)
        for win in bp.windows:
            res.stats[res._key(d, nn, mb, s, npods, sched, win,
                               fault_tag)] = (
                eng.assemble(tr[d], s, celeris_timeout_us=to,
                             adaptive=False, window=win)
                if d == "celeris" else st)


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
