"""Transport-simulation parameters (port of
``repro/core/transport/params.py``; paper §IV evaluation setup).

128-node 2-tier Clos, 100G host links, 25 MB AllReduce rounds, bursty
randomized background traffic injected to create contention.

Plain dataclasses, copied as they are, so the port's engine and the
numpy engine read the same numbers.  The backend switch is not ported:
the port's engine takes a ``device`` instead.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NetworkParams:
    n_nodes: int = 128
    nodes_per_tor: int = 16
    link_gbps: float = 100.0
    mtu_bytes: int = 4096
    base_rtt_us: float = 8.0            # propagation + switching, intra-fabric

    # background traffic: Markov-modulated bursts per ToR uplink.
    # Bursts are rare but long (mean ~1/off_prob steps), so some rounds
    # sail through an idle fabric while others ride out a storm — the
    # bimodality that produces realistic p99/p50 ratios.
    burst_on_prob: float = 0.00012      # P(burst starts) per ToR-step
    burst_off_prob: float = 0.02        # P(burst ends) per step -> ~50-step bursts
    burst_occupancy_lo: float = 0.55    # link share taken while bursting
    burst_occupancy_hi: float = 0.95
    idle_occupancy: float = 0.05

    # share of line rate left for the foreground flow under contention
    bg_bandwidth_weight: float = 0.80
    min_avail_frac: float = 0.30

    # queueing / loss model (switch buffer ~ 2 ms drain at 100G)
    queue_capacity_us: float = 100.0    # max queueing delay at full buffer
    ecn_threshold: float = 0.45         # occupancy that starts ECN marking
    loss_knee: float = 0.55             # occupancy where drops begin
    loss_max_prob: float = 0.025        # per-packet drop prob at occupancy 1

    # PFC (RoCE only): pauses can cascade hop-by-hop into storms
    pfc_threshold: float = 0.80         # occupancy triggering PAUSE upstream
    pfc_pause_us: float = 120.0         # quanta-scale pause duration
    pfc_cascade_prob: float = 0.30      # chance each pause propagates further
    pfc_max_cascade: int = 6

    @property
    def link_bytes_per_us(self) -> float:
        return self.link_gbps * 1e9 / 8 / 1e6

    @property
    def pkt_time_us(self) -> float:
        return self.mtu_bytes / self.link_bytes_per_us


@dataclasses.dataclass(frozen=True)
class TopologyParams:
    """Hierarchical multi-pod extension of the flat 2-tier Clos.

    ``n_pods=1`` (the default) is the flat fabric — every code path is
    bit-identical to the pre-topology engine.  With ``n_pods > 1`` the
    cluster splits into contiguous pods of ``n_nodes / n_pods`` nodes;
    ring hops that cross a pod boundary traverse a DCI (data-center
    interconnect) uplink with its own burst process, an
    oversubscription penalty, and extra propagation delay.  The DCI
    tier is where the paper's best-effort transport matters most: it is
    the contended, lossy, high-RTT hop that dominates cross-pod tails.

    ``dci_oversubscription`` and ``dci_burst_on_prob`` also accept a
    per-pod tuple (length ``n_pods``) so asymmetric "hot pod"
    scenarios are expressible — one pod's DCI uplink oversubscribed or
    bursting harder than the others.  A cross-pod flow pays the worse
    of its two endpoint pods' oversubscription (it traverses both
    uplinks).  Scalars keep the exact pre-vector code paths, so scalar
    configs stay bit-identical with the flat per-pod model.
    """
    n_pods: int = 1
    # pod egress bandwidth divisor: a 4:1 oversubscribed DCI gives each
    # cross-pod flow 1/4 of the per-link line rate under contention
    dci_oversubscription: "float | tuple" = 4.0
    dci_rtt_us: float = 12.0            # extra one-way propagation, inter-pod

    # DCI burst process: inter-pod links aggregate many jobs, so bursts
    # are far more frequent, hotter, and the idle floor is higher than
    # the ToR uplinks'.
    dci_burst_on_prob: "float | tuple" = 0.003
    dci_burst_off_prob: float = 0.01
    dci_burst_occupancy_lo: float = 0.60
    dci_burst_occupancy_hi: float = 0.97
    dci_idle_occupancy: float = 0.10

    @property
    def hierarchical(self) -> bool:
        return self.n_pods > 1


@dataclasses.dataclass(frozen=True)
class DcqcnParams:
    """DCQCN rate control (kept in hardware on all four designs)."""
    alpha_g: float = 0.00390625         # 1/256 alpha EWMA gain
    rate_decrease_floor: float = 0.30   # min rate fraction after cuts
    additive_increase: float = 0.05     # RAI per increase event (fraction)
    hyper_increase: float = 0.05        # HAI after sustained no-congestion
    hyper_after: int = 5                # stages before hyper increase
    min_rate: float = 0.30


@dataclasses.dataclass(frozen=True)
class ReliabilityParams:
    """Per-design recovery behavior knobs."""
    nack_delay_us: float = 4.0          # NACK generation + return latency
    rto_us: float = 1000.0              # RoCE retransmission timeout
    rto_low_us: float = 100.0           # IRN/SRNIC low RTO (tail-loss probe)
    host_slowpath_us: float = 25.0      # SRNIC SW retransmission handling
    max_retries: int = 3


@dataclasses.dataclass(frozen=True)
class WindowPolicy:
    """How the Celeris bounded budget binds one engine round.

    A "round" is one pass over the active :class:`FlowPlan` — a
    collective AllReduce for the ring/hier/perrail schedules, or an
    arbitrary point-to-point plan (e.g. the serve path's KV-transfer
    incast).  The policy decides where inside the round the budget
    truncates:

    - ``"round"`` — one deadline for the whole round (the paper's
      adaptive-timeout policy; bit-exact with the pre-policy engine);
    - ``"phase"`` — the same budget split across the collective
      schedule's phase blocks by their ``budget_frac`` weights, each
      block truncated at its own deadline.  Expensive (DCI) phases get
      a proportionally larger share — "wait longer where the fabric is
      slow, cut losses where it's cheap".  On a single-phase (ring)
      plan the split is ``[1.0]`` and the policy degenerates to
      ``"round"`` bit-for-bit.
    - ``"step"`` — per-step deadlines: each phase's budget share is
      divided uniformly over its steps (the beyond-paper fig2 policy).
      On a single-phase plan this is the pre-policy per-step window
      unchanged; multi-phase plans split per ``budget_frac`` first.
    """
    kind: str = "round"

    KINDS = ("round", "phase", "step")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown window policy {self.kind!r}; "
                             f"choose from {self.KINDS}")

    @classmethod
    def parse(cls, v: "WindowPolicy | str") -> "WindowPolicy":
        return v if isinstance(v, cls) else cls(kind=str(v))


@dataclasses.dataclass(frozen=True)
class FaultParams:
    """Seeded NIC / link failure processes (OptiNIC taxonomy).

    All rates default to 0: the default config draws from no fault
    stream and perturbs no existing seeded trace.  Faults are
    engine-native (shared-stream mode only): each process has its own random substream derived from
    the user seed (``faults.py``), so the same seed reproduces the same
    failure scenario across designs and schedules.

    - **NIC stall** (``stall_rate`` per node-step): delivery through the
      node pauses for ``stall_steps`` steps — a firmware hiccup or PCIe
      backpressure event, the paper's "NIC resilience" headline case;
    - **NIC crash** (``crash_rate`` per node-step): the node goes dead
      mid-round — permanently (``crash_restart_steps=0``) or until a
      restart after that many steps;
    - **link flap** (``flap_rate`` per edge-step): a ToR uplink (and,
      on multi-pod fabrics, a DCI uplink) goes down/up as a Markov
      on/off chain with recovery probability ``flap_recover_prob``;
    - **rail failure** (``rail_fail_rate`` per round): the cross-pod
      exchange loses rail ``rail`` for the round — under the ``hier``
      leader exchange (leaders are rank 0) a rail-0 failure kills the
      whole DCI phase, under ``perrail`` it kills 1/m of the rails (the
      blast-radius experiment of the per-rail schedule);
    - **slow-NIC straggler** (``straggler_frac`` of nodes): a static
      seeded subset of NICs runs at ``1/straggler_slowdown`` of the
      DCQCN-granted rate for the whole trace.

    ``target_nodes`` restricts the node-level processes (stall, crash,
    straggler) to a node subset — e.g. one pod, for the faulted-pod
    end-to-end training experiment.
    """
    stall_rate: float = 0.0
    stall_steps: int = 8
    crash_rate: float = 0.0
    crash_restart_steps: int = 0        # 0 => dead for the whole trace
    flap_rate: float = 0.0
    flap_recover_prob: float = 0.25
    rail_fail_rate: float = 0.0
    rail: int = 0
    straggler_frac: float = 0.0
    straggler_slowdown: float = 4.0
    target_nodes: "tuple | None" = None

    KINDS = ("stall", "crash", "flap", "rail", "straggler")

    def __post_init__(self):
        for name in ("stall_rate", "crash_rate", "flap_rate",
                     "rail_fail_rate", "flap_recover_prob",
                     "straggler_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} must lie in [0, 1]")
        if self.stall_steps < 1:
            raise ValueError(f"stall_steps={self.stall_steps} must be >= 1")
        if self.straggler_slowdown < 1.0:
            raise ValueError("straggler_slowdown must be >= 1")
        if self.target_nodes is not None:
            object.__setattr__(self, "target_nodes",
                               tuple(int(i) for i in self.target_nodes))

    @property
    def active(self) -> bool:
        return (self.stall_rate > 0 or self.crash_rate > 0
                or self.flap_rate > 0 or self.rail_fail_rate > 0
                or self.straggler_frac > 0)

    @property
    def tag(self) -> str:
        """Compact label for sweep keys / benchmark rows."""
        if not self.active:
            return "none"
        parts = []
        for kind, rate in (("stall", self.stall_rate),
                           ("crash", self.crash_rate),
                           ("flap", self.flap_rate),
                           ("rail", self.rail_fail_rate),
                           ("straggler", self.straggler_frac)):
            if rate > 0:
                parts.append(f"{kind}:{rate:g}")
        return "+".join(parts)

    @classmethod
    def of_kind(cls, kind: str, rate: float, **kw) -> "FaultParams":
        """One fault process by name at the given rate."""
        field = {"stall": "stall_rate", "crash": "crash_rate",
                 "flap": "flap_rate", "rail": "rail_fail_rate",
                 "straggler": "straggler_frac"}.get(kind)
        if field is None:
            raise ValueError(f"unknown fault kind {kind!r}; choose from "
                             f"{cls.KINDS}")
        return cls(**{field: rate}, **kw)

    @classmethod
    def parse(cls, spec: "FaultParams | str") -> "FaultParams":
        """CLI form ``kind:rate`` (e.g. ``stall:0.001``), ``+``-joined
        for compound scenarios (``stall:0.001+flap:0.0005``)."""
        if isinstance(spec, cls):
            return spec
        kw = {}
        for part in str(spec).split("+"):
            kind, _, rate = part.partition(":")
            probe = cls.of_kind(kind.strip(), float(rate or 0.0))
            kw.update({f.name: getattr(probe, f.name)
                       for f in dataclasses.fields(cls)
                       if getattr(probe, f.name) != f.default})
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    message_bytes: int = 25 * 1024 * 1024   # 25 MB per node per round
    # collective schedule riding the fabric (core/transport/schedule.py):
    # "ring" — flat 2(N-1)-step ring RS+AG, every step message/N bytes;
    # "hier" — reduce-scatter within pod -> pod-leader DCI exchange with
    # 1/n_pods-sized shards -> all-gather within pod;
    # "perrail" — hier with every node crossing pods (rank-aligned
    # rails moving 1/(m*n_pods)-sized shards).
    schedule: str = "ring"


@dataclasses.dataclass(frozen=True)
class SimParams:
    net: NetworkParams = NetworkParams()
    dcqcn: DcqcnParams = DcqcnParams()
    rel: ReliabilityParams = ReliabilityParams()
    work: WorkloadParams = WorkloadParams()
    topo: TopologyParams = TopologyParams()
    fault: FaultParams = FaultParams()
    seed: int = 0
