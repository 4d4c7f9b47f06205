"""Flight-recorder telemetry: tail attribution for the batched engine
(port of ``repro/core/transport/telemetry.py``).

An opt-in pure overlay on the engine's shared-fabric pass
(``BatchedEngine(params, recorder=TraceRecorder())``):

- the device core (``engine_torch._core``) keeps, per phase and design,
  the component tensors it already computes: serialization
  (``n_pkts * pkt_time``), queueing, RTT (half the base RTT, plus the
  DCI propagation on cross-pod columns), RoCE's PFC pause, the reliable
  designs' retransmit excess, the fault reactions' added time
  (``faults.apply_to_result(parts=)``), and the wire- and fault-lost
  packets.  It reduces them on the device to what
  :meth:`TraceRecorder.record_phase` keeps: the critical flow per step
  (the argmax of the times whose max is the step's natural duration),
  the components at that flow, per-tier component sums (the incast
  carve-out ``serialize * (1 - 1/fan)`` on fan-in > 1 columns) and
  per-tier delivered, wire-lost and fault-lost packets; only those
  ``(S, rows, tiers, components)`` tensors come back to the host;
- the fabric counters (:meth:`TraceRecorder.record_fabric`) are
  reductions of the host pass's occupancy and drop curves, and the
  window cut is attributed at ``assemble`` time from the trace/stats
  pair (:meth:`TraceRecorder.record_assemble`).

Recording draws nothing and adds nothing to the arrays the times and
delivered packets are computed from, so stats with the recorder on are
bit-identical to stats with it off.  :func:`audit_round` asserts the
conservation laws that make the attribution trustworthy, and
:class:`DropProvenance` carries it across the stack boundary
(``coupling.schedule_from_engine(record=True)``).  The Perfetto export is
``trace_export``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.transport import topology

# Time components of a flow's completion, in display order.  "incast"
# is the egress-sharing share of serialization on fan-in > 1 columns
# (fan senders share one receiver port: of the fan-x serialization
# stretch, the 1 - 1/fan share is contention, not wire time).
COMPONENTS = ("serialize", "queue", "rtt", "pfc", "retransmit",
              "incast", "fault")
N_COMPONENTS = len(COMPONENTS)

# Loss causes, in attribution order: packets dropped on the wire
# (Celeris's unrecovered overflow losses), packets swallowed by a NIC
# fault (stall / crash), packets cut by the bounded receiver window.
CAUSES = ("wire_drop", "fault", "window_cut")
N_CAUSES = len(CAUSES)
_WIRE, _FAULT, _CUT = range(N_CAUSES)

# Components that are recovery machinery rather than data movement —
# the "why reliable tails explode" bucket fig9 headlines.
RECOVERY_COMPONENTS = ("pfc", "retransmit", "fault")


class ConservationError(AssertionError):
    """A recorded attribution failed to conserve to the engine totals."""


def _ck(ok: bool, msg: str) -> None:
    if not ok:
        raise ConservationError(msg)


@dataclasses.dataclass
class DesignRecord:
    """Attribution events for one design over one ``traces()`` pass.

    All arrays are float64 reductions of the engine's own blocks; T is
    the full trace length (rounds x steps_per_round).  The critical
    flow of a step is the argmax-completion-time flow — the one whose
    time *is* the step's natural duration, so ``comp_crit.sum(-1)``
    telescopes to the round times (up to engine float32 rounding;
    :func:`audit_round` pins the tolerance).
    """
    design: str
    n_rounds: int
    steps: int
    phase_names: tuple
    phase_of_step: np.ndarray           # (steps,) in-round phase index
    comp_crit: np.ndarray               # (T, n_components) critical flow
    crit_tier: np.ndarray               # (T,) critical flow's tier index
    crit_src: np.ndarray                # (T,) critical flow's sender node
    comp_tier: np.ndarray               # (T, n_tiers, n_components)
    lost_pkts: np.ndarray               # (T, n_tiers, 2) wire/fault lost
    offered_pkts: np.ndarray            # (T, n_tiers)
    delivered_pkts: np.ndarray          # (T, n_tiers) post-fault, pre-window
    # filled by TraceRecorder.record_assemble (None until assembled)
    natural_us: np.ndarray | None = None     # (R,) un-windowed round time
    elapsed_us: np.ndarray | None = None     # (R,) stats.times_us
    windowed_pkts: np.ndarray | None = None  # (R, n_tiers) survive window
    window_cut_pkts: np.ndarray | None = None  # (R, n_tiers)
    prio_offered_pkts: np.ndarray | None = None    # (R, n_classes)
    prio_window_cut_pkts: np.ndarray | None = None  # (R, n_classes)
    stats: "object | None" = None            # the assembled RoundStats

    # -- derived views -------------------------------------------------
    def round_components(self) -> np.ndarray:
        """(R, n_components) critical-path time per round per component."""
        return self.comp_crit.reshape(self.n_rounds, self.steps,
                                      N_COMPONENTS).sum(axis=1)

    def phase_components(self) -> np.ndarray:
        """(R, n_phases, n_components) critical-path time by phase."""
        cc = self.comp_crit.reshape(self.n_rounds, self.steps, N_COMPONENTS)
        out = np.zeros((self.n_rounds, len(self.phase_names), N_COMPONENTS))
        for k in range(len(self.phase_names)):
            out[:, k] = cc[:, self.phase_of_step == k].sum(axis=1)
        return out

    def loss_by_cause(self) -> np.ndarray:
        """(R, n_tiers, n_causes) lost packets per round, all causes.

        The window_cut column requires :meth:`TraceRecorder
        .record_assemble` to have run (i.e. the trace was assembled by
        an engine holding this recorder); it is zero otherwise.
        """
        lp = self.lost_pkts.reshape(self.n_rounds, self.steps,
                                    topology.N_TIERS, 2).sum(axis=1)
        out = np.zeros((self.n_rounds, topology.N_TIERS, N_CAUSES))
        out[:, :, _WIRE] = lp[:, :, 0]
        out[:, :, _FAULT] = lp[:, :, 1]
        if self.window_cut_pkts is not None:
            out[:, :, _CUT] = self.window_cut_pkts
        return out

    def phase_lost_pkts(self) -> np.ndarray:
        """(R, n_phases, n_tiers, 2) wire/fault lost packets by phase.

        Window cuts are not phase-resolved (the round/phase window cut
        is accounted per tier group at assemble time); use
        :meth:`loss_by_cause` for the full three-cause picture.
        """
        lp = self.lost_pkts.reshape(self.n_rounds, self.steps,
                                    topology.N_TIERS, 2)
        out = np.zeros((self.n_rounds, len(self.phase_names),
                        topology.N_TIERS, 2))
        for k in range(len(self.phase_names)):
            out[:, k] = lp[:, self.phase_of_step == k].sum(axis=1)
        return out

    def offered_round(self) -> np.ndarray:
        """(R, n_tiers) offered packets per round."""
        return self.offered_pkts.reshape(self.n_rounds, self.steps,
                                         topology.N_TIERS).sum(axis=1)

    def delivered_round(self) -> np.ndarray:
        """(R, n_tiers) post-fault (pre-window) delivered packets."""
        return self.delivered_pkts.reshape(self.n_rounds, self.steps,
                                           topology.N_TIERS).sum(axis=1)

    def loss_rates(self) -> np.ndarray:
        """(R, n_causes) lost fraction of the round's offered payload
        by cause — the serve path's per-request attribution input."""
        lost = self.loss_by_cause().sum(axis=1)
        offered = np.maximum(self.offered_round().sum(axis=1), 1.0)
        return lost / offered[:, None]

    def tail_rounds(self, q: float = 99.0) -> np.ndarray:
        """(R,) bool — rounds at or above the q-th natural-time
        percentile (natural = un-windowed: the tail the fabric
        produced, before any window policy bounded it)."""
        t = (self.natural_us if self.natural_us is not None
             else self.round_components().sum(axis=1))
        return t >= np.percentile(t, q)


class TraceRecorder:
    """Opt-in flight recorder for :class:`~repro_torch.core.transport
    .engine.BatchedEngine` (shared-fabric mode, one seed a pass).

    Pass one to the engine (``BatchedEngine(params, recorder=rec)``) and
    run ``traces`` + ``assemble`` as usual; the recorder fills one
    :class:`DesignRecord` per design, readable via :meth:`record`.
    Recording draws no random numbers and changes nothing the physics
    reads, so stats with the recorder on are bit-identical to stats with
    it off.  One recorder serves one ``traces()`` pass at a time
    (``begin`` resets it); legacy stream-replay mode is refused.
    """

    def __init__(self):
        self.records: Dict[str, DesignRecord] = {}
        # design-independent fabric counters (export counter tracks)
        self.fabric: Dict[str, np.ndarray] = {}
        self._active = False

    # -- engine-facing hooks -------------------------------------------
    def begin(self, design_list, *, plan, n_rounds: int, steps: int) -> None:
        T = n_rounds * steps
        names = tuple(ph.name for ph in plan.phases)
        pos = np.asarray(plan.phase_of_step)
        self.records = {
            d: DesignRecord(
                design=d, n_rounds=n_rounds, steps=steps,
                phase_names=names, phase_of_step=pos,
                comp_crit=np.zeros((T, N_COMPONENTS)),
                crit_tier=np.full(T, -1, dtype=np.int8),
                crit_src=np.full(T, -1, dtype=np.int32),
                comp_tier=np.zeros((T, topology.N_TIERS, N_COMPONENTS)),
                lost_pkts=np.zeros((T, topology.N_TIERS, 2)),
                offered_pkts=np.zeros((T, topology.N_TIERS)),
                delivered_pkts=np.zeros((T, topology.N_TIERS)))
            for d in design_list}
        self.fabric = {}
        self._active = True

    def record_fabric(self, rows: np.ndarray, counters: Dict[str, np.ndarray],
                      T: int) -> None:
        """Design-independent per-step fabric counters (see
        ``network.congestion_counters``), keyed by absolute step rows."""
        for name, v in counters.items():
            if name not in self.fabric:
                self.fabric[name] = np.zeros(T)
            self.fabric[name][rows] = v

    def record_phase(self, design: str, rows: np.ndarray, ph, hg, n_pkts: int,
                     reduced: Dict[str, np.ndarray]) -> None:
        """Write one (design, phase, block) reduction into the record.

        ``rows`` are absolute step indices, ``ph`` the SchedulePhase,
        ``hg`` its HierGeometry (flow→tier columns), ``n_pkts`` its
        packets per flow, and ``reduced`` the device core's reductions
        of this phase block for one seed: ``ar`` ``(rows,)`` the critical
        flow, ``crit`` ``(rows, n_components)`` its components,
        ``tier`` ``(rows, n_tiers, n_components)`` the per-tier component
        sums, and ``pkts`` ``(rows, n_tiers, 3)`` the per-tier delivered,
        wire-lost and fault-lost packets (float64 throughout).
        """
        rec = self.records[design]
        ar = reduced["ar"]
        rec.comp_crit[rows] = reduced["crit"]
        tier_of_flow = np.full(ph.src.size, -1, dtype=np.int8)
        for k, cols in enumerate(hg.tier_cols):
            tier_of_flow[cols] = k
        rec.crit_tier[rows] = tier_of_flow[ar]
        rec.crit_src[rows] = np.asarray(ph.src)[ar]
        pk = reduced["pkts"]
        for k, cols in enumerate(hg.tier_cols):
            if not cols.size:
                continue
            rec.comp_tier[rows, k] = reduced["tier"][:, k]
            rec.offered_pkts[rows, k] = float(n_pkts * cols.size)
            rec.delivered_pkts[rows, k] = pk[:, k, 0]
            rec.lost_pkts[rows, k] = pk[:, k, 1:]

    def record_assemble(self, trace, stats) -> None:
        """Window attribution: called by ``BatchedEngine.assemble`` on
        every packed RoundStats.  The cut per (round, tier) is the gap
        between what the fabric delivered (post-fault) and what
        survived the bounded window; for reliable designs it is zero
        by construction."""
        rec = self.records.get(trace.design)
        if rec is None:
            return
        steps = trace.steps_per_round
        R = trace.nat_us.shape[0] // steps
        rec.natural_us = trace.nat_us.reshape(R, steps).sum(axis=1)
        rec.elapsed_us = np.asarray(stats.times_us, np.float64)
        rec.stats = stats
        if trace.tier_deliv is not None and stats.tier_recv_frac is not None:
            full = trace.tier_deliv.reshape(R, steps, -1).sum(axis=1)
            tot = trace.tier_total.reshape(R, steps, -1).sum(axis=1)
            windowed = np.asarray(stats.tier_recv_frac, np.float64) * tot
            rec.windowed_pkts = windowed
            rec.window_cut_pkts = np.maximum(full - windowed, 0.0)
        if (trace.step_priority is not None
                and stats.prio_recv_frac is not None):
            # same attribution regrouped by priority class: under
            # cut_order="priority" the cut concentrates in class 0, and
            # the per-class columns sum to the per-tier cut exactly
            # (audit_round pins the recombination)
            cls = np.asarray(trace.step_priority, dtype=int)
            C = np.asarray(stats.prio_recv_frac).shape[1]
            onehot = (cls[:, None] == np.arange(C)[None, :])
            d = trace.deliv.reshape(R, steps)
            t = trace.total.reshape(R, steps)
            full_c = (d[:, :, None] * onehot[None, :, :]).sum(axis=1)
            tot_c = (t[:, :, None] * onehot[None, :, :]).sum(axis=1)
            windowed_c = np.asarray(stats.prio_recv_frac,
                                    np.float64) * tot_c
            rec.prio_offered_pkts = tot_c
            rec.prio_window_cut_pkts = np.maximum(full_c - windowed_c, 0.0)

    # -- reading -------------------------------------------------------
    def record(self, design: str) -> DesignRecord:
        try:
            return self.records[design]
        except KeyError:
            raise KeyError(
                f"no record for design {design!r}: recorder saw "
                f"{sorted(self.records)} — was it attached before "
                "traces() ran?") from None


# ----------------------------------------------------------------------
# Conservation audit
# ----------------------------------------------------------------------

def audit_round(stats, record: DesignRecord | None = None, *,
                time_rtol: float = 2e-5,
                pkt_rtol: float = 1e-9) -> Dict[str, float]:
    """Assert the conservation laws tying attribution to round totals.

    Standalone (``record=None``) it audits :class:`RoundStats` internal
    consistency: finite positive times, fractions in [0, 1], tier
    fractions recombining (offered-packet weighted) to the scalar
    delivered fraction, pod + DCI accounting recombining to the tier
    accounting.  With a :class:`DesignRecord` it additionally asserts

    - critical-path component sums equal the un-windowed round times
      (within engine float32 accumulation rounding: ``time_rtol``),
    - for reliable designs, un-windowed equals assembled round time
      exactly; for Celeris, elapsed <= natural and the cut is >= 0,
    - delivered + wire_drop + fault + window_cut == offered, per
      (round, tier), exactly up to float64 rounding (``pkt_rtol``),
    - the recorder's own offered/delivered reductions match the
      engine trace's independent tier reductions.

    Returns a small summary dict (max relative errors observed).
    Raises :class:`ConservationError` on any violation.
    """
    times = np.asarray(stats.times_us, np.float64)
    fr = np.asarray(stats.recv_frac, np.float64)
    _ck(bool(np.isfinite(times).all()) and bool((times > 0).all()),
        "round times must be finite and positive")
    _ck(bool((fr > -1e-12).all()) and bool((fr < 1 + 1e-9).all()),
        "recv_frac out of [0, 1]")
    out: Dict[str, float] = {"rounds": float(times.size)}

    if stats.tier_recv_frac is not None and stats.tier_pkts is not None:
        w = np.asarray(stats.tier_pkts, np.float64)
        if w.sum() > 0:
            recomb = (np.asarray(stats.tier_recv_frac, np.float64)
                      * w).sum(axis=1) / w.sum()
            err = float(np.abs(recomb - fr).max())
            out["tier_recomb_abs_err"] = err
            _ck(err < 1e-9, f"tier fractions do not recombine to "
                            f"recv_frac (abs err {err:.2e})")
    if (stats.pod_recv_frac is not None and stats.pod_pkts is not None
            and stats.tier_recv_frac is not None
            and stats.tier_pkts is not None):
        w = np.asarray(stats.tier_pkts, np.float64)
        intra_pod = (np.asarray(stats.pod_recv_frac, np.float64)
                     * np.asarray(stats.pod_pkts, np.float64)).sum(axis=1)
        intra_tier = (np.asarray(stats.tier_recv_frac, np.float64)[:, :2]
                      * w[:2]).sum(axis=1)
        err = float(np.abs(intra_pod - intra_tier).max()
                    / max(float(w[:2].sum()), 1.0))
        out["pod_recomb_rel_err"] = err
        _ck(err < 1e-9, f"pod intra accounting does not recombine to "
                        f"tier intra accounting (rel err {err:.2e})")

    if record is None:
        return out

    _ck(record.natural_us is not None,
        "record not assembled: run engine.assemble() with the recorder "
        "attached before auditing")
    comp = record.round_components()
    nat = record.natural_us
    err = float(np.abs(comp.sum(axis=1) - nat).max()
                / max(float(nat.max()), 1e-9))
    out["time_rel_err"] = err
    _ck(err < time_rtol,
        f"component times do not conserve to round times "
        f"(rel err {err:.2e} > {time_rtol:.0e})")
    if record.design != "celeris":
        _ck(bool(np.array_equal(record.elapsed_us, nat)),
            "reliable-design assembled times differ from natural times")
    else:
        _ck(bool((record.elapsed_us <= nat * (1 + 1e-12) + 1e-9).all()),
            "celeris elapsed time exceeds natural time")
        if record.window_cut_pkts is not None:
            _ck(bool((record.window_cut_pkts > -1e-6).all()),
                "negative window cut")

    offered = record.offered_round()
    delivered = record.delivered_round()
    lost = record.loss_by_cause()
    scale = max(float(offered.max()), 1.0)
    # recorder reduction vs the engine trace's independent reduction
    if record.windowed_pkts is not None:
        accounted = record.windowed_pkts + lost.sum(axis=2)
    else:
        accounted = delivered + lost[:, :, :2].sum(axis=2)
    err = float(np.abs(accounted - offered).max() / scale)
    out["pkt_rel_err"] = err
    _ck(err < max(pkt_rtol, 1e-12),
        f"delivered + per-cause losses do not conserve to offered "
        f"packets (rel err {err:.2e})")
    wf = delivered + lost[:, :, :2].sum(axis=2)
    err = float(np.abs(wf - offered).max() / scale)
    _ck(err < max(pkt_rtol, 1e-12),
        f"pre-window delivered + wire/fault losses do not conserve "
        f"(rel err {err:.2e})")
    if (record.prio_window_cut_pkts is not None
            and record.window_cut_pkts is not None):
        # the priority-class regrouping must account for the same cut
        # bytes as the tier grouping (both slice one survive vector)
        err = float(np.abs(record.prio_window_cut_pkts.sum(axis=1)
                           - record.window_cut_pkts.sum(axis=1)).max()
                    / scale)
        out["prio_cut_recomb_rel_err"] = err
        _ck(err < 1e-9,
            f"per-priority-class window cuts do not recombine to the "
            f"per-tier window cuts (rel err {err:.2e})")
    if record.stats is not None and record.stats.tier_pkts is not None:
        tp = np.asarray(record.stats.tier_pkts, np.float64)
        err = float(np.abs(offered - tp[None, :]).max() / scale)
        out["offered_vs_plan_rel_err"] = err
        _ck(err < 1e-9,
            f"recorder offered packets disagree with the plan's "
            f"tier_pkts (rel err {err:.2e})")
    return out


# ----------------------------------------------------------------------
# Drop provenance (the stack-boundary tag coupling/serve carry)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DropProvenance:
    """Where a :class:`~repro_torch.core.transport.coupling.DropSchedule`'s
    dropped fractions came from: per-(step, cause) loss rates plus the
    tier/phase context, so a trainer- or serve-side recovery metric can
    be attributed end-to-end.  ``rates`` are *unclipped* attribution
    (DropSchedule clips its own rates to MAX_DROP; the provenance keeps
    the physical split).  ``phase_rates`` resolves the wire/fault
    causes by schedule phase; window cuts are tier- but not
    phase-resolved (see :meth:`DesignRecord.phase_lost_pkts`).
    """
    axis: str                         # "flat" | "intra" | "cross"
    tiers: tuple                      # topology.TIERS subset feeding it
    causes: tuple                     # CAUSES order
    rates: np.ndarray                 # (R, n_causes) loss frac by cause
    phases: tuple = ()                # schedule phase names
    phase_rates: np.ndarray | None = None  # (R, n_phases) wire+fault frac
    source: str = "recorded"          # "recorded" | "heuristic"

    def total(self) -> np.ndarray:
        return self.rates.sum(axis=1)

    def mean_by_cause(self) -> Dict[str, float]:
        return {c: float(self.rates[:, i].mean())
                for i, c in enumerate(self.causes)}

    def dominant_cause(self) -> str:
        return self.causes[int(np.argmax(self.rates.sum(axis=0)))]

    def describe(self) -> str:
        """One line: 'cross[dci]: 0.031 window_cut + 0.004 fault (...)'."""
        by = self.mean_by_cause()
        parts = " + ".join(f"{v:.4f} {c}" for c, v in sorted(
            by.items(), key=lambda kv: -kv[1]) if v > 0) or "0 loss"
        return (f"{self.axis}[{','.join(self.tiers)}]: {parts} "
                f"({self.source})")


_AXIS_TIERS = {"flat": (0, 1, 2), "intra": (0, 1), "cross": (2,)}


def provenance_from_record(record: DesignRecord, axis: str
                           ) -> DropProvenance:
    """Exact per-cause provenance for one coupling axis from a
    :class:`DesignRecord` (requires an assembled record)."""
    ti = list(_AXIS_TIERS[axis])
    lost = record.loss_by_cause()[:, ti, :].sum(axis=1)       # (R, causes)
    offered = np.maximum(record.offered_round()[:, ti].sum(axis=1), 1.0)
    rates = lost / offered[:, None]
    ph_lost = record.phase_lost_pkts()[:, :, ti, :].sum(axis=(2, 3))
    return DropProvenance(
        axis=axis, tiers=tuple(topology.TIERS[k] for k in ti),
        causes=CAUSES, rates=rates, phases=record.phase_names,
        phase_rates=ph_lost / offered[:, None], source="recorded")


def provenance_heuristic(stats, axis: str) -> DropProvenance:
    """Cause attribution from :class:`RoundStats` alone (no recorder):
    loss in fault-exposed rounds is tagged "fault"; the remainder is
    "window_cut" for Celeris (the bounded window is what realizes its
    loss) and "wire_drop" otherwise.  Coarse by construction — run the
    engine with a :class:`TraceRecorder` for the exact split."""
    ti = list(_AXIS_TIERS[axis])
    if stats.tier_recv_frac is not None and stats.tier_pkts is not None:
        w = np.asarray(stats.tier_pkts, np.float64)[ti]
        if w.sum() > 0:
            loss = 1.0 - (np.asarray(stats.tier_recv_frac, np.float64)[:, ti]
                          * w).sum(axis=1) / w.sum()
        else:
            loss = np.zeros(np.asarray(stats.recv_frac).shape[0])
    else:
        loss = 1.0 - np.asarray(stats.recv_frac, np.float64)
    loss = np.maximum(loss, 0.0)
    rates = np.zeros((loss.size, N_CAUSES))
    faulted = stats.faulted
    resid = _CUT if stats.design == "celeris" else _WIRE
    rates[faulted, _FAULT] = loss[faulted]
    rates[~faulted, resid] = loss[~faulted]
    return DropProvenance(
        axis=axis, tiers=tuple(topology.TIERS[k] for k in ti),
        causes=CAUSES, rates=rates, source="heuristic")
