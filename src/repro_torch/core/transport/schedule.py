"""Flow plans and the collective schedules (port of
``repro/core/transport/schedule.py``: ``SchedulePhase``, ``FlowPlan``,
``flow_plan``, ``with_step_priorities``, ``layer_priorities``, and the
ring, hierarchical and per-rail schedules).

A :class:`FlowPlan` is one round of point-to-point flow phases: each
phase a contiguous run of steps sharing one static flow pattern, so it
stays a dense ``(step, flow)`` block in the engine.  For ``n_pods`` pods
of ``m = N / n_pods`` nodes and an ``M``-byte message:

- :class:`RingSchedule`: one phase of ``2(N-1)`` steps of ``M/N`` bytes
  between ring neighbours;
- :class:`HierarchicalSchedule`: ``rs`` (reduce-scatter inside each pod,
  ``m-1`` steps of ``M/m``), ``dci`` (the pod leaders' ring over the
  DCI, ``2(n_pods-1)`` steps of ``M/n_pods``), ``ag`` (all-gather inside
  each pod, as ``rs``);
- :class:`PerRailHierarchicalSchedule`: the same, with every node
  crossing pods on its rank's rail in ``dci`` (shards of
  ``M/(m n_pods)``).

Each phase carries a window-budget weight (``budget_frac``: nominal
unloaded phase time, the DCI phase paying the mean oversubscription and
the extra propagation), which :meth:`FlowPlan.budget_fracs` normalizes
into the per-phase split of the Celeris round budget
(``window="phase"``), and a semantic priority class.

Arbitrary static plans come from :func:`flow_plan` (each node sends at
most one flow per phase).  Several flows sharing a receiver
(``SchedulePhase.fan_in() > 1``) are **incast**, e.g. the serve path's
prefill -> decode KV shipping (``serve/traffic.py``); the engine charges
those flows with per-receiver contention, and a fan-in-1 plan runs
exactly as the collective schedules do.  :func:`layer_priorities`
promotes the trailing half of the all-gather to a top priority class,
the classes the engine's ``cut_order="priority"`` window cut reorders
by (Fig. 10).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.transport import topology
from repro_torch.core.transport.params import (NetworkParams, TopologyParams,
                                               WorkloadParams)


@dataclasses.dataclass(frozen=True, eq=False)
class SchedulePhase:
    """A contiguous run of steps sharing one static flow pattern.

    ``payload_bytes`` is per flow per step; a flow's sender column in
    the engine's ``(step, node)`` tensors is its ``src`` node.
    ``budget_frac`` is the phase's un-normalized window-budget weight
    (None: its nominal serialization share ``n_steps * payload_bytes``);
    ``priority`` its semantic class (assembly-time metadata only).
    """
    name: str
    src: np.ndarray            # (n_flows,) sender node per flow
    dst: np.ndarray            # (n_flows,) receiver node per flow
    n_steps: int               # steps of this phase per round
    payload_bytes: int         # bytes per flow per step
    budget_frac: float | None = None   # window-budget weight (un-normalized)
    priority: int = 0          # semantic class (higher = cut later)

    def n_pkts(self, net: NetworkParams) -> int:
        """Packets per flow per step (payload split at the MTU, >= 1)."""
        return max(1, self.payload_bytes // net.mtu_bytes)

    @property
    def budget_weight(self) -> float:
        return (float(self.n_steps * self.payload_bytes)
                if self.budget_frac is None else float(self.budget_frac))

    def fan_in(self) -> np.ndarray:
        """(n_flows,) how many of this phase's flows share flow ``i``'s
        receiver: all ones on a permutation (every collective schedule),
        > 1 on incast flows."""
        counts = np.bincount(self.dst, minlength=int(self.dst.max()) + 1)
        return counts[self.dst]


@dataclasses.dataclass(frozen=True, eq=False)
class FlowPlan:
    """One round of point-to-point flow phases, resolved for a topology.

    Collective schedules give fan-in-1 plans; :func:`flow_plan` builds
    arbitrary ones (incast among them).  ``priority_of_step`` overrides
    the phases' priority classes step by step (serve plans bucket steps
    inside one phase); it is assembly-time metadata only.
    """
    schedule: str
    phases: tuple              # of SchedulePhase, in execution order
    steps_per_round: int
    phase_of_step: np.ndarray  # (steps_per_round,) phase index per step
    priority_of_step: np.ndarray | None = None

    @property
    def single_phase(self) -> bool:
        return len(self.phases) == 1

    @property
    def phase_names(self) -> tuple:
        """Phase names in execution order."""
        return tuple(ph.name for ph in self.phases)

    def max_fan_in(self) -> int:
        """Largest per-receiver sender count over all phases (1 for every
        collective schedule; > 1 marks an incast plan)."""
        return max(int(ph.fan_in().max()) for ph in self.phases)

    def geometries(self, net: NetworkParams, topo: TopologyParams) -> tuple:
        """Per-phase :class:`topology.HierGeometry` (flow→tier maps)."""
        return tuple(topology.hier_geometry(net, topo, src=ph.src,
                                            dst=ph.dst)
                     for ph in self.phases)

    def tier_counts(self, net: NetworkParams, topo: TopologyParams,
                    geometries: tuple | None = None) -> np.ndarray:
        """(n_tiers,) flows per tier, summed over phases."""
        gs = geometries if geometries is not None else self.geometries(
            net, topo)
        out = np.zeros(topology.N_TIERS, dtype=int)
        for hg in gs:
            out += hg.tier_counts
        return out

    def tier_pkts_round(self, net: NetworkParams, topo: TopologyParams,
                        geometries: tuple | None = None) -> np.ndarray:
        """(n_tiers,) offered packets per round per tier."""
        gs = geometries if geometries is not None else self.geometries(
            net, topo)
        out = np.zeros(topology.N_TIERS)
        for ph, hg in zip(self.phases, gs):
            out += hg.tier_counts * (ph.n_pkts(net) * ph.n_steps)
        return out

    def pod_pkts_round(self, net: NetworkParams, topo: TopologyParams,
                       geometries: tuple | None = None) -> np.ndarray:
        """(n_pods,) offered intra-pod packets per round per pod (DCI
        flows belong to the cross axis)."""
        gs = geometries if geometries is not None else self.geometries(
            net, topo)
        out = np.zeros(topo.n_pods)
        for ph, hg in zip(self.phases, gs):
            for p, cols in enumerate(hg.pod_cols):
                out[p] += cols.size * ph.n_pkts(net) * ph.n_steps
        return out

    def budget_fracs(self) -> np.ndarray:
        """(n_phases,) normalized per-phase split of the Celeris round
        budget; exactly ``[1.0]`` on a single-phase plan."""
        w = np.array([ph.budget_weight for ph in self.phases])
        return w / w.sum()

    def step_priority(self) -> np.ndarray:
        """(steps_per_round,) semantic priority class per step: the
        per-step override where the plan carries one, else the phases'
        classes."""
        if self.priority_of_step is not None:
            return np.asarray(self.priority_of_step, dtype=int)
        return np.repeat(np.array([ph.priority for ph in self.phases],
                                  dtype=int),
                         [ph.n_steps for ph in self.phases])

    def n_priority_classes(self) -> int:
        """Number of priority classes (``max class + 1``; >= 1)."""
        return int(self.step_priority().max()) + 1

    def prio_pkts_round(self, net: NetworkParams) -> np.ndarray:
        """(n_classes,) offered packets per round per priority class (the
        per-class analogue of :meth:`tier_pkts_round`)."""
        cls = self.step_priority()
        out = np.zeros(self.n_priority_classes())
        for ph, rows in zip(self.phases,
                            np.split(np.arange(self.steps_per_round),
                                     np.cumsum([ph.n_steps for ph
                                                in self.phases])[:-1])):
            per_step = ph.src.size * ph.n_pkts(net)
            np.add.at(out, cls[rows], float(per_step))
        return out

    def bytes_per_round(self) -> int:
        """Bytes offered to the fabric per round (all flows, all
        steps)."""
        return sum(ph.src.size * ph.n_steps * ph.payload_bytes
                   for ph in self.phases)


def _mk_plan(name: str, phases) -> FlowPlan:
    phases = tuple(ph for ph in phases if ph.n_steps > 0)
    steps = sum(ph.n_steps for ph in phases)
    phase_of_step = np.repeat(np.arange(len(phases)),
                              [ph.n_steps for ph in phases])
    return FlowPlan(schedule=name, phases=phases, steps_per_round=steps,
                    phase_of_step=phase_of_step)


def flow_plan(name: str, phases) -> FlowPlan:
    """A validated :class:`FlowPlan` from arbitrary static phases.

    Per phase: ``src``/``dst`` equal-length, 1-D and non-empty, no
    self-flows, and unique senders (the engine's ``(step, node)``
    tensors have one column per node); receivers may repeat (incast).
    Empty phases (``n_steps == 0``) are dropped, as the collective
    schedules drop them.
    """
    for ph in phases:
        if ph.n_steps == 0:
            continue                    # dropped by _mk_plan below
        src, dst = np.asarray(ph.src), np.asarray(ph.dst)
        if src.shape != dst.shape or src.ndim != 1 or src.size == 0:
            raise ValueError(
                f"phase {ph.name!r}: src/dst must be equal-length 1-D "
                f"non-empty arrays, got {src.shape} vs {dst.shape}")
        if np.unique(src).size != src.size:
            raise ValueError(
                f"phase {ph.name!r}: duplicate senders — each node "
                "drives at most one flow per step (the engine's "
                "(step, node) tensors scatter by sender column)")
        if (src == dst).any():
            raise ValueError(f"phase {ph.name!r}: self-flows (src == dst)")
        if ph.payload_bytes < 1:
            raise ValueError(
                f"phase {ph.name!r}: payload_bytes must be >= 1")
        if ph.priority < 0:
            raise ValueError(
                f"phase {ph.name!r}: priority class must be >= 0")
    plan = _mk_plan(name, phases)
    if not plan.phases:
        raise ValueError("flow plan has no non-empty phases")
    return plan


def with_step_priorities(plan: FlowPlan, priority_of_step) -> FlowPlan:
    """``plan`` with a validated per-step priority override (timing and
    phases untouched)."""
    cls = np.asarray(priority_of_step, dtype=int)
    if cls.shape != (plan.steps_per_round,):
        raise ValueError(
            f"priority_of_step must have shape ({plan.steps_per_round},), "
            f"got {cls.shape}")
    if (cls < 0).any():
        raise ValueError("priority classes must be >= 0")
    return dataclasses.replace(plan, priority_of_step=cls)


def layer_priorities(plan: FlowPlan, top_frac: float = 0.5) -> np.ndarray:
    """Layer-depth priority classes for a hierarchical training plan.

    The trailing ``top_frac`` of the final all-gather phase carries the
    early-layer exact shards the next forward pass consumes first, so
    those steps are promoted to a new top class above every phase
    priority: e.g. ``dci=0 < rs/early-ag=1 < late-ag=2``.  The bounded
    window then cuts coded DCI bytes first and the forward-critical
    shards last, the inverse of the arrival cut.  Plans without an
    all-gather phase (flat ring, serve) come back unchanged.  Feed the
    result to :func:`with_step_priorities`.
    """
    cls = plan.step_priority().copy()
    pos = np.asarray(plan.phase_of_step)
    is_ag = np.array([plan.phases[k].name.startswith("ag") for k in pos])
    ag_steps = np.where(is_ag)[0]
    n_top = int(round(ag_steps.size * top_frac))
    if n_top:
        cls[ag_steps[ag_steps.size - n_top:]] = cls.max() + 1
    return cls


class CollectiveSchedule:
    """Produces the per-step flow plan the engine times."""

    name: str = "?"

    def plan(self, net: NetworkParams, topo: TopologyParams,
             work: WorkloadParams) -> FlowPlan:
        raise NotImplementedError


class RingSchedule(CollectiveSchedule):
    """Flat ring RS+AG over all nodes: ``2(N-1)`` steps of ``M/N``
    bytes."""

    name = "ring"

    def plan(self, net, topo, work):
        n = net.n_nodes
        src = np.arange(n)
        ring = SchedulePhase(name="ring", src=src, dst=(src + 1) % n,
                             n_steps=2 * (n - 1),
                             payload_bytes=work.message_bytes // n)
        return _mk_plan(self.name, (ring,))


def _mean_oversub(topo: TopologyParams) -> float:
    """Mean DCI oversubscription ratio (per-pod vectors average)."""
    return float(np.mean(topology.per_pod_array(
        topo.dci_oversubscription, topo.n_pods, "dci_oversubscription")))


def _nominal_us(net: NetworkParams, n_steps: int, payload_bytes: int,
                extra_rtt_us: float = 0.0, slowdown: float = 1.0) -> float:
    """Nominal unloaded phase time: per-step serialization (scaled by the
    tier's slowdown) plus the half-RTT floor, summed over steps."""
    return n_steps * (payload_bytes / net.link_bytes_per_us * slowdown
                      + net.base_rtt_us / 2 + extra_rtt_us)


class HierarchicalSchedule(CollectiveSchedule):
    """Reduce-scatter within pod -> leader DCI exchange -> all-gather
    within pod."""

    name = "hier"
    # Execution order of the phases; the trainer's HIERARCHICAL sync
    # (exact intra-pod first, coded cross-pod second) asserts it.
    PHASE_ORDER = ("rs", "dci", "ag")
    # Semantic priority classes: the coded DCI shards are cut first; the
    # HIERARCHICAL sync asserts the DCI phase is the lowest class.
    PRIORITY = {"rs": 1, "dci": 0, "ag": 1}

    def _dci_phase(self, net, topo, work, m: int) -> SchedulePhase:
        """The leader exchange: one flow per pod, ``M/n_pods`` shards."""
        n_pods = topo.n_pods
        leaders = np.arange(n_pods) * m
        return SchedulePhase(
            name="dci", src=leaders,
            dst=((np.arange(n_pods) + 1) % n_pods) * m,
            n_steps=2 * (n_pods - 1),
            payload_bytes=work.message_bytes // n_pods)

    def plan(self, net, topo, work):
        topology.validate(net, topo)
        n, n_pods = net.n_nodes, topo.n_pods
        if n_pods == 1:
            # the degenerate hierarchy is the flat ring
            return dataclasses.replace(RingSchedule().plan(net, topo, work),
                                       schedule=self.name)
        m = n // n_pods
        src = np.arange(n)
        pod = src // m
        nxt = pod * m + (src - pod * m + 1) % m     # intra-pod ring
        dci = self._dci_phase(net, topo, work, m)
        rs = SchedulePhase(name="rs", src=src, dst=nxt, n_steps=m - 1,
                           payload_bytes=work.message_bytes // m)
        intra_w = _nominal_us(net, rs.n_steps, rs.payload_bytes)
        dci_w = _nominal_us(net, dci.n_steps, dci.payload_bytes,
                            extra_rtt_us=topo.dci_rtt_us / 2,
                            slowdown=_mean_oversub(topo))
        phases = (
            dataclasses.replace(rs, budget_frac=intra_w,
                                priority=self.PRIORITY["rs"]),
            dataclasses.replace(dci, budget_frac=dci_w,
                                priority=self.PRIORITY["dci"]),
            dataclasses.replace(rs, name="ag", budget_frac=intra_w,
                                priority=self.PRIORITY["ag"]),
        )
        assert tuple(ph.name for ph in phases) == self.PHASE_ORDER
        return _mk_plan(self.name, phases)


class PerRailHierarchicalSchedule(HierarchicalSchedule):
    """Hierarchical exchange with every node crossing pods: node (pod i,
    rank j) rings over pods on rail j, ``M/(m n_pods)``-byte shards for
    ``2(n_pods-1)`` steps."""

    name = "perrail"

    def _dci_phase(self, net, topo, work, m: int) -> SchedulePhase:
        n_pods = topo.n_pods
        src = np.arange(m * n_pods)
        pod, rank = src // m, src % m
        return SchedulePhase(
            name="dci", src=src,
            dst=((pod + 1) % n_pods) * m + rank,
            n_steps=2 * (n_pods - 1),
            payload_bytes=work.message_bytes // (m * n_pods))


SCHEDULES = {cls.name: cls for cls in (RingSchedule, HierarchicalSchedule,
                                       PerRailHierarchicalSchedule)}


def get_schedule(name: str) -> CollectiveSchedule:
    try:
        return SCHEDULES[name]()
    except KeyError:
        raise ValueError(f"unknown collective schedule {name!r}; choose "
                         f"from {sorted(SCHEDULES)}") from None


def make_plan(net: NetworkParams, topo: TopologyParams,
              work: WorkloadParams) -> FlowPlan:
    """The plan for ``work.schedule`` on this topology."""
    return get_schedule(work.schedule).plan(net, topo, work)
