"""Transport coupling (port of ``repro/core/transport/coupling.py``):
the bridge from the transport engine to the trainer and the server.

- :class:`DropSchedule`: a per-step drop-probability trace with
  provenance, consumed one step at a time by the trainer;
- :func:`schedule_from_round_stats`: engine ``RoundStats`` -> schedule
  (drop = 1 - delivered fraction per round; one AllReduce round maps to
  one train step);
- :func:`schedule_from_engine`: run the engine (on ``device``) at a
  given scale and window tightness and return its schedule; the paper's
  Fig.-1 drop regimes are settings of ``timeout_scale``;
- :class:`EngineStragglerModel`: feeds a schedule to the Trainer's
  ``straggler.drop_rate(timeout, rng)`` interface;
- the hierarchical (multi-pod) coupling: :class:`AxisSchedules` splits
  the engine's per-tier delivered fractions into an intra-pod and a
  cross-pod (DCI) schedule, refined per pod when the engine tracked
  pods (:func:`split_schedule_from_round_stats`,
  :func:`split_schedule_from_engine`, which takes a fault scenario), and
  :class:`HierStragglerModel` walks them, feeding the trainer a
  ``(2,)`` ``[intra, cross]`` or ``(n_pods + 1,)`` ``[intra_pod0, ...,
  cross]`` drop vector per step;
- ``kv_hole_masks`` (delivered KV fractions -> per-request hole masks)
  and :class:`CollectiveMode` (the switch the train step dispatches on).

- the priority-class schedules (:class:`PrioritySchedules`,
  :func:`priority_schedules_from_round_stats`): one drop schedule per
  semantic class from a ``cut_order="priority"`` engine run;
- the closed form (:class:`LatencyTail`, :func:`closed_form_schedule`):
  a schedule from a timeout trace under the lognormal latency tail of
  the trainer's ``StragglerModel``, without running the engine.

The schedules carry a :class:`telemetry.DropProvenance`: exact per-(tier,
cause, phase) when the engine ran with the flight recorder
(``record=True``), heuristic otherwise.

numpy and the standard library around the engine, copied as they are, so
the masks are bit-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import enum
from math import erf, sqrt

import numpy as np

from repro_torch.core.transport import telemetry, topology
from repro_torch.core.transport.engine import BatchedEngine, RoundStats
from repro_torch.core.transport.params import SimParams

# seeded substream id of the KV hole masks (``repro/serve/traffic.py``)
STREAM_KV_HOLES = 162


def kv_hole_masks(kv_frac: np.ndarray, n_rot: int, seed: int = 0
                  ) -> np.ndarray:
    """Seeded per-request wire-row arrival masks for KV-cache shipping.

    Turns each request's delivered KV fraction into a ``(n_req, n_rot)``
    boolean mask over wire rows.  Row ``j`` arriving means coordinate
    ``j`` of every Hadamard rotation block survived the window
    (``core.coding``'s wire layout).

    Masks are Bernoulli(kv_frac) per row on the seeded
    ``STREAM_KV_HOLES`` substream.  Requests with ``kv_frac == 1`` get
    all-true masks (the draw is still consumed, keeping masks
    per-request reproducible regardless of which other requests were cut).
    """
    kv_frac = np.asarray(kv_frac, dtype=float)
    rng = np.random.default_rng([seed, STREAM_KV_HOLES])
    u = rng.random((kv_frac.size, n_rot))
    return u < kv_frac[:, None]


class CollectiveMode(enum.Enum):
    """Gradient-sync collective flavor for the train step.

    - ``EXACT``: lossless all-reduce (RoCE-like semantics, the baseline);
    - ``LOSSY``: best-effort without coding: a wire row that misses the
      receiver's bounded window is a hole in the raw gradient;
    - ``LOSSY_HADAMARD``: best-effort + randomized-Hadamard coding, the
      paper's recovery path, unbiased even through holes;
    - ``HIERARCHICAL``: exact intra-pod, coded lossy cross-pod (on one
      device: the coded emulation at the drop vector's cross component).
    """
    EXACT = "exact"
    LOSSY = "lossy"
    LOSSY_HADAMARD = "lossy_hadamard"
    HIERARCHICAL = "hierarchical"

    @classmethod
    def parse(cls, mode: "CollectiveMode | str") -> "CollectiveMode":
        if isinstance(mode, cls):
            return mode
        key = str(mode).lower().replace("+", "_").replace("-", "_")
        for m in cls:
            if m.value == key:
                return m
        raise ValueError(f"unknown collective mode {mode!r}; choose from "
                         f"{[m.value for m in cls]}")

    @property
    def lossy(self) -> bool:
        return self is not CollectiveMode.EXACT

    @property
    def coded(self) -> bool:
        return self in (CollectiveMode.LOSSY_HADAMARD,
                        CollectiveMode.HIERARCHICAL)

    @property
    def hierarchical(self) -> bool:
        return self is CollectiveMode.HIERARCHICAL


# The collectives emulate loss at wire-chunk granularity; a drop rate
# past ~0.5 means the window is mis-tuned, not a tail event, and the
# unbias factors blow up variance: clamp like the trainer's model does.
MAX_DROP = 0.5


@dataclasses.dataclass(frozen=True)
class DropSchedule:
    """Per-train-step drop probabilities with provenance.

    ``rates[i]`` is the drop probability for train step i, clamped to
    ``[0, MAX_DROP]``; steps past the end wrap around (an engine trace is
    a stationary sample of the fabric, so tiling it is the natural
    extension).  ``provenance`` (a :class:`telemetry.DropProvenance`,
    when the schedule came from engine stats) attributes each step's
    dropped fraction to a cause; it keeps the unclipped split.
    """
    rates: np.ndarray
    source: str = "constant"
    provenance: "telemetry.DropProvenance | None" = None

    def __post_init__(self):
        object.__setattr__(
            self, "rates",
            np.clip(np.asarray(self.rates, dtype=np.float64).reshape(-1),
                    0.0, MAX_DROP))
        if self.rates.size == 0:
            raise ValueError("empty drop schedule")

    def rate(self, step: int) -> float:
        return float(self.rates[step % self.rates.size])

    @property
    def mean(self) -> float:
        return float(self.rates.mean())

    @property
    def p99(self) -> float:
        return float(np.percentile(self.rates, 99))


def schedule_from_round_stats(stats: RoundStats, *,
                              source: str | None = None,
                              record: "telemetry.DesignRecord | None" = None
                              ) -> DropSchedule:
    """Engine round statistics -> per-step schedule (round i = step i).

    Pass the matching :class:`telemetry.DesignRecord` (from the recorder
    the engine ran with) for exact per-cause provenance; without it the
    heuristic attribution is attached."""
    prov = (telemetry.provenance_from_record(record, "flat")
            if record is not None
            else telemetry.provenance_heuristic(stats, "flat"))
    return DropSchedule(
        rates=1.0 - np.asarray(stats.recv_frac, dtype=np.float64),
        source=source or f"engine:{stats.design}", provenance=prov)


def schedule_from_engine(n_rounds: int, seed: int = 0, *,
                         params: SimParams | None = None,
                         n_nodes: int | None = None,
                         message_mb: float | None = None,
                         design: str = "celeris",
                         timeout_scale: float = 1.0,
                         adaptive: bool = False,
                         window: str = "round",
                         legacy_streams: bool = False,
                         record: bool = False,
                         device: str = "cuda") -> DropSchedule:
    """Run the transport engine on ``device`` and derive the drop
    schedule it implies.

    The Celeris window follows the paper protocol (fixed at the RoCE
    baseline's median + 1 sigma on the *same* fabric trace), scaled by
    ``timeout_scale``: 1.0 is the paper's Fig.-1 operating point (~1%
    loss at 128 nodes); smaller values tighten the window into heavier
    drop regimes.  ``adaptive=True`` runs the per-round timeout
    controller instead of the fixed window.  ``params`` may carry a
    multi-pod topology, a hierarchical schedule or a fault scenario, as
    in the JAX package; the schedule is then the flat one over all tiers
    (:func:`split_schedule_from_engine` splits it by axis).  Lossless
    designs ("roce", "irn", "srnic") yield all-zero schedules.
    ``legacy_streams=True`` replays the sequential simulator's streams
    (flat ring only).  ``record=True`` runs the engine with a
    ``telemetry.TraceRecorder`` (in the shared-fabric mode, whatever
    ``legacy_streams`` says), so the schedule's ``provenance`` carries
    the exact per-(tier, cause, phase) attribution.
    """
    p = params or SimParams()
    if n_nodes is not None:
        p = dataclasses.replace(
            p, net=dataclasses.replace(p.net, n_nodes=n_nodes))
    if message_mb is not None:
        p = dataclasses.replace(
            p, work=dataclasses.replace(p.work,
                                        message_bytes=int(message_mb * 2**20)))
    rec = telemetry.TraceRecorder() if record else None
    eng = BatchedEngine(p, device=device, recorder=rec)
    designs_needed = [design] if design != "celeris" else ["roce", "celeris"]
    tr = eng.traces(designs_needed, n_rounds, seed,
                    legacy_streams=legacy_streams and not record)
    if design != "celeris":
        stats = eng.assemble(tr[design], seed)
    else:
        base = eng.assemble(tr["roce"], seed)
        to = float((np.percentile(base.times_us, 50) + base.times_us.std())
                   * timeout_scale)
        stats = eng.assemble(tr["celeris"], seed, celeris_timeout_us=to,
                             adaptive=adaptive, window=window)
    tag = (f"engine:{design} n={p.net.n_nodes} seed={seed} "
           f"scale={timeout_scale}" + (" adaptive" if adaptive else ""))
    return schedule_from_round_stats(
        stats, source=tag,
        record=rec.record(design) if rec is not None else None)


# ----------------------------------------------------------------------
# Axis-split schedules (hierarchical multi-pod topologies)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisSchedules:
    """Per-axis drop schedules for a hierarchical topology: ``intra``
    (ToR + spine tiers, weighted by the plan's per-tier packets) and
    ``cross`` (the DCI tier); ``per_pod`` refines ``intra`` per pod when
    the engine tracked pods.  :meth:`rates` is ``(n_pods + 1,)``
    ``[intra_pod0, ..., cross]`` or ``(2,)`` ``[intra, cross]``: the cross
    component is last in both."""
    intra: DropSchedule
    cross: DropSchedule
    per_pod: tuple | None = None       # of DropSchedule, one per pod
    source: str = ""

    @property
    def n_pods(self) -> int | None:
        return None if self.per_pod is None else len(self.per_pod)

    def rates(self, step: int) -> np.ndarray:
        if self.per_pod is not None:
            return np.array([s.rate(step) for s in self.per_pod]
                            + [self.cross.rate(step)])
        return np.array([self.intra.rate(step), self.cross.rate(step)])

    # the schedule-walk interface shared with DropSchedule
    rate = rates

    @property
    def mean(self) -> tuple[float, float]:
        return (self.intra.mean, self.cross.mean)


def split_schedule_from_round_stats(stats: RoundStats, *,
                                    source: str | None = None,
                                    record: "telemetry.DesignRecord | None"
                                    = None) -> AxisSchedules:
    """Engine per-tier round statistics -> axis-split schedules.

    The tier fractions combine into the intra axis weighted by the
    plan's offered packets per tier (``stats.tier_pkts``; the flow
    counts when absent); the DCI tier is the cross axis.  Per-pod
    fractions, where tracked, give one intra schedule per pod.  The intra
    and cross schedules carry exact provenance when ``record`` (the
    engine run's :class:`telemetry.DesignRecord`) is given, heuristic
    otherwise.
    """
    if stats.tier_recv_frac is None or stats.tier_counts is None:
        raise ValueError("RoundStats lacks per-tier fractions: build it "
                         "through BatchedEngine.assemble")
    f = np.asarray(stats.tier_recv_frac, dtype=np.float64)
    w = np.asarray(stats.tier_pkts if stats.tier_pkts is not None
                   else stats.tier_counts, dtype=np.float64)
    w_intra = w[:2].sum()
    if w_intra > 0:
        intra = 1.0 - (f[:, :2] * w[:2]).sum(axis=1) / w_intra
    else:
        intra = np.zeros(f.shape[0])
    cross = (1.0 - f[:, 2]) if w[2] > 0 else np.zeros(f.shape[0])
    tag = source or f"engine:{stats.design}"
    if record is not None:
        prov_i = telemetry.provenance_from_record(record, "intra")
        prov_c = telemetry.provenance_from_record(record, "cross")
    else:
        prov_i = telemetry.provenance_heuristic(stats, "intra")
        prov_c = telemetry.provenance_heuristic(stats, "cross")
    per_pod = None
    if stats.pod_recv_frac is not None:
        pf = np.asarray(stats.pod_recv_frac, dtype=np.float64)
        per_pod = tuple(
            DropSchedule(rates=1.0 - pf[:, p], source=f"{tag}:pod{p}")
            for p in range(pf.shape[1]))
    return AxisSchedules(
        intra=DropSchedule(rates=intra, source=tag + ":intra",
                           provenance=prov_i),
        cross=DropSchedule(rates=cross, source=tag + ":cross",
                           provenance=prov_c),
        per_pod=per_pod, source=tag)


def split_schedule_from_engine(n_rounds: int, seed: int = 0, *,
                               params: SimParams | None = None,
                               n_pods: int = 2,
                               n_nodes: int | None = None,
                               dci_oversubscription: "float | tuple | None"
                               = None,
                               schedule: str | None = None,
                               window: str = "round",
                               timeout_scale: float = 1.0,
                               fault=None,
                               record: bool = False,
                               device: str = "cuda") -> AxisSchedules:
    """Run the hierarchical engine on ``device`` and derive the
    axis-split schedule: :func:`topology.hier_protocol` (the RoCE
    baseline on the same fabric fixes the Celeris window at median + 1
    sigma, scaled) on ``n_pods`` pods, with ``schedule`` ("ring" |
    "hier" | "perrail"), ``window`` ("round" | "phase") and an optional
    ``fault`` (a ``FaultParams`` or its ``kind:rate`` string), whose
    faulted pods' loss then reaches the per-pod schedules.
    ``record=True`` attaches exact per-(tier, cause, phase) provenance
    from a ``telemetry.TraceRecorder`` run.
    """
    p = topology.hier_params(n_pods, base=params, n_nodes=n_nodes,
                             dci_oversubscription=dci_oversubscription,
                             schedule=schedule, fault=fault)
    rec = telemetry.TraceRecorder() if record else None
    stats = topology.hier_protocol(p, n_rounds, seed, window=window,
                                   timeout_scale=timeout_scale,
                                   recorder=rec, device=device)["celeris"]
    tag = (f"engine:celeris n={p.net.n_nodes} pods={n_pods} "
           f"sched={p.work.schedule} window={window} seed={seed} "
           f"scale={timeout_scale} fault={p.fault.tag}")
    return split_schedule_from_round_stats(
        stats, source=tag,
        record=rec.record("celeris") if rec is not None else None)


# ----------------------------------------------------------------------
# Priority-class split schedules (semantic-aware window cuts)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrioritySchedules:
    """Per-priority-class drop schedules from a prioritized engine run.

    ``classes[c]`` is the :class:`DropSchedule` of priority class ``c``
    (class 0 = lowest = cut first), ``pkts[c]`` its offered packets per
    round.  Under ``cut_order="priority"`` the low classes soak up the
    window cut: on the hierarchical plans class 0 is the coded DCI
    exchange, so ``low`` aligns with :class:`AxisSchedules`' ``cross``
    axis.  ``rates(step)`` returns the ``(n_classes,)`` vector, low class
    first.
    """
    classes: tuple                      # of DropSchedule, index = class
    pkts: np.ndarray                    # (n_classes,) offered pkts/round
    source: str = ""

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def low(self) -> DropSchedule:
        """The cut-first class (coded / recoverable bytes)."""
        return self.classes[0]

    @property
    def high(self) -> DropSchedule:
        """The cut-last class (exact / high-value bytes)."""
        return self.classes[-1]

    def rates(self, step: int) -> np.ndarray:
        return np.array([s.rate(step) for s in self.classes])

    # schedule-walk interface shared with DropSchedule/AxisSchedules
    rate = rates

    @property
    def mean(self) -> tuple:
        return tuple(s.mean for s in self.classes)


def priority_schedules_from_round_stats(stats: RoundStats, *,
                                        source: str | None = None
                                        ) -> PrioritySchedules:
    """Engine per-class round statistics -> per-priority-class schedules.

    Requires the stats to carry per-class fractions (any
    ``BatchedEngine.assemble`` of an engine-built trace, either
    ``cut_order``); raises otherwise.  Classes with no offered packets
    get all-zero schedules (nothing to drop).
    """
    if stats.prio_recv_frac is None or stats.prio_pkts is None:
        raise ValueError(
            "RoundStats lacks per-priority-class fractions — build it "
            "through BatchedEngine.assemble on a plan-built trace "
            "(stream-replay / reference paths don't track priority "
            "classes)")
    f = np.asarray(stats.prio_recv_frac, dtype=np.float64)
    pk = np.asarray(stats.prio_pkts, dtype=np.float64)
    tag = source or f"engine:{stats.design}"
    classes = tuple(
        DropSchedule(rates=(1.0 - f[:, c]) if pk[c] > 0
                     else np.zeros(f.shape[0]),
                     source=f"{tag}:prio{c}")
        for c in range(f.shape[1]))
    return PrioritySchedules(classes=classes, pkts=pk, source=tag)


# ----------------------------------------------------------------------
# Closed-form alternative (no engine run needed)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LatencyTail:
    """Lognormal per-chunk latency tail, the transport model's contention
    shape.  Identical math to the trainer's standalone
    ``StragglerModel`` with bursts disabled."""
    median_latency: float = 1.0       # in units of clean step time
    sigma: float = 0.6

    def drop_rate(self, timeout: float) -> float:
        """P(latency > timeout) under lognormal(ln median, sigma)."""
        z = ((np.log(max(float(timeout), 1e-9))
              - np.log(self.median_latency)) / self.sigma)
        p_late = 0.5 * (1.0 - erf(z / sqrt(2.0)))
        return float(np.clip(p_late, 0.0, MAX_DROP))


def closed_form_schedule(timeouts, model: LatencyTail | None = None
                         ) -> DropSchedule:
    """Per-step drop from a timeout trace (e.g. the controller's
    adopted windows), without running the engine."""
    m = model or LatencyTail()
    rates = np.array([m.drop_rate(t) for t in np.atleast_1d(timeouts)])
    return DropSchedule(rates=rates, source="closed_form")


# ----------------------------------------------------------------------
# Trainer adapter
# ----------------------------------------------------------------------

class EngineStragglerModel:
    """Feed an engine-derived schedule into the Trainer.

    Duck-typed stand-in for ``train.trainer.StragglerModel``: the trainer
    calls ``drop_rate(timeout, rng)`` once per train step, which walks
    the schedule in order (wrapping).  ``timeout``/``rng`` are accepted
    for interface parity but unused: the engine already resolved the
    window when the schedule was built.
    """

    def __init__(self, schedule: DropSchedule, median_latency: float = 1.0):
        self.schedule = schedule
        self.steps_taken = 0
        # the trainer's bounded-window emulation reads this to model the
        # clean per-step latency (units of clean step time)
        self.median_latency = median_latency

    def drop_rate(self, timeout: float, rng) -> "float | np.ndarray":
        p = self.schedule.rate(self.steps_taken)
        self.steps_taken += 1
        return p


class HierStragglerModel(EngineStragglerModel):
    """Feed an :class:`AxisSchedules` into the Trainer: ``drop_rate``
    returns the per-axis vector the hierarchical train step consumes,
    ``(n_pods + 1,)`` or ``(2,)``, its cross (DCI) component last."""

    @property
    def schedules(self) -> AxisSchedules:
        return self.schedule
