"""Flow-to-tier geometry (port of ``repro/core/transport/topology.py``:
the tier axis and the static flow-to-tier map, for a flat fabric).

The port's engine runs one pod (``n_pods == 1``): the DCI overlay, its
streams and the hierarchical protocol are not ported yet, and the engine
raises on ``n_pods > 1``.  On one pod every flow is on the ``tor`` tier
(same ToR) or the ``spine`` tier (cross-ToR); the ``dci`` column stays
empty but keeps its place, so per-tier arrays have the JAX package's
shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.transport.params import NetworkParams, TopologyParams

# Tier axis order used everywhere a per-tier quantity appears.
TIERS = ("tor", "spine", "dci")
N_TIERS = len(TIERS)


def per_pod_array(value, n_pods: int, name: str = "parameter") -> np.ndarray:
    """(n_pods,) f64 view of a scalar-or-per-pod topology parameter."""
    a = np.asarray(value, dtype=np.float64).reshape(-1)
    if a.size == 1:
        return np.full(n_pods, a[0])
    if a.size != n_pods:
        raise ValueError(f"per-pod {name} has length {a.size}; expected a "
                         f"scalar or one value per pod (n_pods={n_pods})")
    return a


def validate(net: NetworkParams, topo: TopologyParams) -> None:
    if topo.n_pods < 1:
        raise ValueError(f"n_pods={topo.n_pods} must be >= 1")
    if net.n_nodes % topo.n_pods:
        raise ValueError(f"n_nodes={net.n_nodes} must be a multiple of "
                         f"n_pods={topo.n_pods}")
    per_pod = net.n_nodes // topo.n_pods
    if per_pod % net.nodes_per_tor:
        raise ValueError(
            f"nodes per pod ({per_pod}) must be a multiple of "
            f"nodes_per_tor={net.nodes_per_tor} (pods align to ToRs)")
    if (per_pod_array(topo.dci_oversubscription, topo.n_pods,
                      "dci_oversubscription") < 1.0).any():
        raise ValueError("dci_oversubscription must be >= 1")
    bp = per_pod_array(topo.dci_burst_on_prob, topo.n_pods,
                       "dci_burst_on_prob")
    if ((bp < 0.0) | (bp > 1.0)).any():
        raise ValueError("dci_burst_on_prob must lie in [0, 1]")


@dataclasses.dataclass(frozen=True)
class HierGeometry:
    """Static per-flow topology facts for one collective flow pattern."""
    n_pods: int
    pod_of: np.ndarray         # (n,) pod index per node
    src: np.ndarray            # (n_flows,) source node per flow
    dst: np.ndarray            # (n_flows,) destination node per flow
    src_pod: np.ndarray        # (n_flows,) pod of each flow's source
    dst_pod: np.ndarray        # (n_flows,) pod of each flow's destination
    tiers: np.ndarray          # (n_flows,) tier index per flow (into TIERS)
    tier_cols: tuple           # per tier: flow-column index array
    cross: np.ndarray          # alias of tier_cols[2] (dci flows)

    @property
    def tier_counts(self) -> np.ndarray:
        return np.array([c.size for c in self.tier_cols])


def hier_geometry(net: NetworkParams, topo: TopologyParams,
                  src: np.ndarray | None = None,
                  dst: np.ndarray | None = None) -> HierGeometry:
    """Tier assignment per flow (default: ring, src=i, dst=(i+1) mod n)."""
    validate(net, topo)
    n = net.n_nodes
    if src is None:
        src = np.arange(n)
    if dst is None:
        dst = (np.arange(n) + 1) % n
    per_pod = n // topo.n_pods
    pod_of = np.arange(n) // per_pod
    ts, td = src // net.nodes_per_tor, dst // net.nodes_per_tor
    sp, dp = pod_of[src], pod_of[dst]
    tiers = np.where(sp != dp, 2, np.where(ts != td, 1, 0))
    tier_cols = tuple(np.flatnonzero(tiers == k) for k in range(N_TIERS))
    return HierGeometry(n_pods=topo.n_pods, pod_of=pod_of, src=src, dst=dst,
                        src_pod=sp, dst_pod=dp, tiers=tiers,
                        tier_cols=tier_cols, cross=tier_cols[2])
