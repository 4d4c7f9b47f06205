"""Drop provenance (port of ``repro/core/transport/telemetry.py``: the
``DropProvenance`` tag that ``coupling.schedule_from_round_stats``
attaches, and its heuristic attribution).

The flight recorder (``TraceRecorder``) is not ported yet, so the
provenance is always the heuristic one: loss in fault-exposed rounds is
"fault"; the rest is "window_cut" for Celeris and "wire_drop" otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.transport import topology

# Loss causes, in attribution order: packets dropped on the wire,
# packets swallowed by a NIC fault, packets cut by the bounded window.
CAUSES = ("wire_drop", "fault", "window_cut")
N_CAUSES = len(CAUSES)
_WIRE, _FAULT, _CUT = range(N_CAUSES)


@dataclasses.dataclass(frozen=True)
class DropProvenance:
    """Where a ``DropSchedule``'s dropped fractions came from: per-(step,
    cause) loss rates plus the tier context.  ``rates`` are unclipped
    (the schedule clips its own rates to ``MAX_DROP``)."""
    axis: str                         # "flat" | "intra" | "cross"
    tiers: tuple                      # topology.TIERS subset feeding it
    causes: tuple                     # CAUSES order
    rates: np.ndarray                 # (R, n_causes) loss frac by cause
    source: str = "heuristic"         # "recorded" once the recorder is in

    def mean_by_cause(self) -> Dict[str, float]:
        return {c: float(self.rates[:, i].mean())
                for i, c in enumerate(self.causes)}

    def describe(self) -> str:
        """One line: 'flat[tor,spine,dci]: 0.031 window_cut (...)'."""
        by = self.mean_by_cause()
        parts = " + ".join(f"{v:.4f} {c}" for c, v in sorted(
            by.items(), key=lambda kv: -kv[1]) if v > 0) or "0 loss"
        return (f"{self.axis}[{','.join(self.tiers)}]: {parts} "
                f"({self.source})")


_AXIS_TIERS = {"flat": (0, 1, 2), "intra": (0, 1), "cross": (2,)}


def provenance_heuristic(stats, axis: str) -> DropProvenance:
    """Cause attribution from ``RoundStats`` alone: loss in fault-exposed
    rounds is tagged "fault"; the remainder is "window_cut" for Celeris
    (the bounded window is what realizes its loss) and "wire_drop"
    otherwise."""
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
