"""Hierarchical multi-pod topology (port of
``repro/core/transport/topology.py``: node -> ToR -> spine -> DCI).

- :func:`hier_geometry`: the static flow-to-tier map (``tor`` same ToR,
  ``spine`` cross-ToR inside a pod, ``dci`` cross-pod);
- :func:`dci_net_params`: the DCI tier's burst process as a
  ``NetworkParams`` clone, so :func:`network.occupancy_trace` drives it
  on its own random substream;
- the DCI overlay on cross-pod flow columns: in the engine's host pass
  (numpy, copied as it is) :func:`overlay_curves` and
  :func:`dci_cnp_draws` decide which draws land where; the
  rate-dependent part is static per-column vectors
  (:func:`dci_columns`) that :func:`overlay_rates` applies, one formula
  for numpy arrays and for the device core's torch tensors;
- :func:`hier_params` and :func:`hier_protocol`, the Fig.-4 protocol on
  the hierarchical fabric, run on ``device``.

At ``n_pods = 1`` the engine never calls the overlay and never draws
from the DCI streams, so flat traces are those of the flat engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.transport import network
from repro_torch.core.transport.params import (FaultParams, NetworkParams,
                                               SimParams, TopologyParams)

# Tier axis order used everywhere a per-tier quantity appears.
TIERS = ("tor", "spine", "dci")
N_TIERS = len(TIERS)

# Engine-native random substreams of the DCI tier (the numpy engine's
# ids, disjoint from the flat engine's 101-120).
STREAM_DCI_FABRIC = 130
STREAM_DCI_CNP = 131


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

    @property
    def pod_cols(self) -> tuple:
        """Per pod: the intra-pod flow columns whose source lives in that
        pod (tor + spine tiers; DCI flows belong to the cross axis)."""
        intra = self.tiers != 2
        return tuple(np.flatnonzero(intra & (self.src_pod == p))
                     for p in range(self.n_pods))


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


def dci_net_params(net: NetworkParams, topo: TopologyParams) -> NetworkParams:
    """The DCI burst process as a NetworkParams clone (one "ToR" per DCI
    uplink).  A per-pod ``dci_burst_on_prob`` broadcasts through the
    burst draws; a scalar stays a scalar."""
    on = topo.dci_burst_on_prob
    if np.ndim(on):
        on = per_pod_array(on, topo.n_pods, "dci_burst_on_prob")
    return dataclasses.replace(
        net,
        burst_on_prob=on,
        burst_off_prob=topo.dci_burst_off_prob,
        burst_occupancy_lo=topo.dci_burst_occupancy_lo,
        burst_occupancy_hi=topo.dci_burst_occupancy_hi,
        idle_occupancy=topo.dci_idle_occupancy)


def init_dci_state(net: NetworkParams, topo: TopologyParams
                   ) -> network.FabricState:
    return network.FabricState(
        bursting=np.zeros(topo.n_pods, dtype=bool),
        occupancy=np.full(topo.n_pods, topo.dci_idle_occupancy))


def overlay_curves(net: NetworkParams, topo: TopologyParams,
                   hg: HierGeometry, occ_tor: np.ndarray,
                   occ_dci: np.ndarray, ecn_p: np.ndarray,
                   drop_p: np.ndarray) -> np.ndarray:
    """Re-evaluate ECN/drop on cross-pod columns at the effective path
    occupancy (max over the ToR uplinks and the two DCI uplinks).

    Mutates ``ecn_p``/``drop_p`` in place (cross columns only) and
    returns the effective f64 occupancy ``(T, n_cross)``.
    """
    x = hg.cross
    if x.size == 0:
        return np.empty((occ_tor.shape[0], 0))
    occ_path = network.path_occupancy_trace(net, occ_tor, hg.src[x],
                                            hg.dst[x])
    occ_pair = np.maximum(occ_dci[:, hg.src_pod[x]], occ_dci[:, hg.dst_pod[x]])
    occ_eff = np.maximum(occ_path, occ_pair)
    ecn_p[:, x] = network.ecn_mark_prob(net, occ_eff)
    drop_p[:, x] = network.drop_prob(net, occ_eff)
    return occ_eff


def dci_oversub_factor(topo: TopologyParams, hg: HierGeometry) -> np.ndarray:
    """The f32 oversubscription factor charged to each cross-pod column
    (an ``np.float32`` scalar, or ``(n_cross,)`` for per-pod vectors: a
    flow pays the worse of its two endpoint pods')."""
    x = hg.cross
    o = topo.dci_oversubscription
    if np.ndim(o) == 0:
        return np.float32(o)
    ov = per_pod_array(o, topo.n_pods, "dci_oversubscription")
    return np.maximum(ov[hg.src_pod[x]],
                      ov[hg.dst_pod[x]]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DciColumns:
    """One phase's DCI overlay as static per-column vectors over its
    flows: the oversubscription factor (f32, 1 off the cross-pod
    columns) and the one-way DCI propagation (f32, 0 off them).  Dividing
    or multiplying a column by exactly 1, or adding 0, leaves it as the
    numpy engine's sliced in-place updates leave it."""
    oversub: np.ndarray        # (n_flows,) float32
    dci_add: np.ndarray        # (n_flows,) float32


def dci_columns(topo: TopologyParams, hg: HierGeometry) -> DciColumns | None:
    """The overlay vectors of one phase, or None when it has no cross-pod
    flow (flat fabrics and the intra-pod phases)."""
    x = hg.cross
    if not topo.hierarchical or x.size == 0:
        return None
    oversub = np.ones(hg.src.size, np.float32)
    oversub[x] = dci_oversub_factor(topo, hg)
    dci_add = np.zeros(hg.src.size, np.float32)
    dci_add[x] = np.float32(topo.dci_rtt_us / 2.0)
    return DciColumns(oversub=oversub, dci_add=dci_add)


def overlay_rates(net: NetworkParams, occ32, rate, oversub):
    """Queueing delay and effective send rate of a phase with its DCI
    overlay: ``occ32`` already holds the effective occupancy on the
    cross-pod columns (the host pass writes it there before the PFC
    draws); the delay is multiplied and the available bandwidth divided
    by the oversubscription.  Operators only, so numpy arrays and torch
    tensors take one formula (``oversub`` of the same kind).  Returns
    ``(qd, eff_rate)``."""
    qd = network.queue_delay_us(net, occ32) * oversub
    return qd, rate * network.avail_bandwidth(net, occ32) / oversub


def dci_cnp_draws(hg: HierGeometry, ecn_p: np.ndarray, cnp: np.ndarray,
                  gen: np.random.Generator) -> None:
    """Extra CNP draws for cross-pod columns from the DCI CNP stream (DCI
    marking is active even when every ToR is calm)."""
    x = hg.cross
    if x.size == 0:
        return
    rows = np.flatnonzero(ecn_p[:, x].any(axis=1))
    if rows.size:
        cnp[np.ix_(rows, x)] = (gen.random((rows.size, x.size))
                                < ecn_p[np.ix_(rows, x)])


# ----------------------------------------------------------------------
# Protocol front-end (Fig. 4 and the axis-split coupling)
# ----------------------------------------------------------------------

def hier_params(n_pods: int, *, base: SimParams | None = None,
                n_nodes: int | None = None,
                dci_oversubscription: "float | tuple | None" = None,
                schedule: str | None = None,
                fault=None,
                **topo_kw) -> SimParams:
    """A SimParams with the topology tier configured.  ``schedule``
    selects the collective schedule ("ring" | "hier" | "perrail");
    ``fault`` a :class:`FaultParams` or its ``kind:rate`` string."""
    p = base or SimParams()
    if n_nodes is not None:
        p = dataclasses.replace(p, net=dataclasses.replace(
            p.net, n_nodes=n_nodes))
    if schedule is not None:
        p = dataclasses.replace(p, work=dataclasses.replace(
            p.work, schedule=schedule))
    if fault is not None:
        p = dataclasses.replace(p, fault=FaultParams.parse(fault))
    kw = dict(n_pods=n_pods, **topo_kw)
    if dci_oversubscription is not None:
        kw["dci_oversubscription"] = dci_oversubscription
    return dataclasses.replace(p, topo=dataclasses.replace(p.topo, **kw))


def hier_protocol(params: SimParams, n_rounds: int = 200, seed: int = 0, *,
                  timeout_scale: float = 1.0, window: str = "round",
                  cut_order: str = "arrival", recorder=None,
                  device: str = "cuda"):
    """Fig.-4 protocol on the hierarchical fabric, run on ``device``.

    The RoCE baseline on the same fabric trace fixes the Celeris window
    at median + 1 sigma (scaled); ``window`` is the Celeris budget policy
    ("round" | "phase") and ``cut_order`` its cut order ("arrival" |
    "priority"); a ``recorder`` (``telemetry.TraceRecorder``) records the
    pass.  Returns ``{design: RoundStats}`` for roce and celeris.
    """
    from repro_torch.core.transport.engine import BatchedEngine

    eng = BatchedEngine(params, recorder=recorder, device=device)
    tr = eng.traces(["roce", "celeris"], n_rounds, seed,
                    legacy_streams=False)
    base = eng.assemble(tr["roce"], seed)
    to = float((np.percentile(base.times_us, 50) + base.times_us.std())
               * timeout_scale)
    cel = eng.assemble(tr["celeris"], seed, celeris_timeout_us=to,
                       adaptive=False, window=window, cut_order=cut_order)
    return {"roce": base, "celeris": cel}
