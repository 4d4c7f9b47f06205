"""Flow plans and the ring schedule (port of
``repro/core/transport/schedule.py``: ``SchedulePhase``, the
``FlowPlan`` members the engine and the window assembly read, and the
flat ring).

A :class:`FlowPlan` is one round of point-to-point flow phases: each
phase a contiguous run of steps sharing one static flow pattern, so it
stays a dense ``(step, flow)`` block in the engine.  The ring schedule
is one phase of ``2(N-1)`` steps moving ``M/N`` bytes between ring
neighbours (reduce-scatter then all-gather over all ``N`` nodes).

The hierarchical and per-rail schedules, arbitrary ``flow_plan``s and
incast are not ported yet: :func:`make_plan` raises on any schedule but
``"ring"`` (see ROADMAP, Queue 1 item 5).
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
    ``priority`` is its semantic class (assembly-time metadata only).
    The per-phase window weight (``budget_frac``) is not ported: on the
    single-phase ring the phase window is the round window.
    """
    name: str
    src: np.ndarray            # (n_flows,) sender node per flow
    dst: np.ndarray            # (n_flows,) receiver node per flow
    n_steps: int               # steps of this phase per round
    payload_bytes: int         # bytes per flow per step
    priority: int = 0          # semantic class (higher = cut later)

    def n_pkts(self, net: NetworkParams) -> int:
        """Packets per flow per step (payload split at the MTU, >= 1)."""
        return max(1, self.payload_bytes // net.mtu_bytes)


@dataclasses.dataclass(frozen=True, eq=False)
class FlowPlan:
    """One round of point-to-point flow phases, resolved for a topology."""
    schedule: str
    phases: tuple              # of SchedulePhase, in execution order
    steps_per_round: int
    phase_of_step: np.ndarray  # (steps_per_round,) phase index per step

    @property
    def single_phase(self) -> bool:
        return len(self.phases) == 1

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

    def step_priority(self) -> np.ndarray:
        """(steps_per_round,) semantic priority class per step."""
        return np.repeat(np.array([ph.priority for ph in self.phases],
                                  dtype=int),
                         [ph.n_steps for ph in self.phases])


def _mk_plan(name: str, phases) -> FlowPlan:
    phases = tuple(ph for ph in phases if ph.n_steps > 0)
    steps = sum(ph.n_steps for ph in phases)
    phase_of_step = np.repeat(np.arange(len(phases)),
                              [ph.n_steps for ph in phases])
    return FlowPlan(schedule=name, phases=phases, steps_per_round=steps,
                    phase_of_step=phase_of_step)


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


def make_plan(net: NetworkParams, topo: TopologyParams,
              work: WorkloadParams) -> FlowPlan:
    """The plan for ``work.schedule`` on this topology (ring only)."""
    if work.schedule != "ring":
        raise NotImplementedError(
            f"schedule={work.schedule!r} is not ported yet: the port runs "
            "the flat ring only (ROADMAP, Queue 1 item 5)")
    return RingSchedule().plan(net, topo, work)
