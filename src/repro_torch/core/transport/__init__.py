"""Transport engine and transport-to-ML coupling (port of
``repro/core/transport/``: the legacy-stream and shared-fabric engine
modes, flat and multi-pod, with the rate-dependent core on the card; the
priority cut, the per-step window and the flight recorder with its
Perfetto export, and the closed-form latency tail)."""
from repro_torch.core.transport.params import (
    SimParams, NetworkParams, DcqcnParams, ReliabilityParams, WorkloadParams,
    TopologyParams, WindowPolicy, FaultParams)
from repro_torch.core.transport.engine import (
    BatchedEngine, BatchedSimParams, RoundStats, SweepResult, sweep)
from repro_torch.core.transport.simulator import CollectiveSimulator
from repro_torch.core.transport.designs import DESIGNS
from repro_torch.core.transport.topology import (
    TIERS, hier_params, hier_protocol)
from repro_torch.core.transport.schedule import (
    layer_priorities, make_plan, with_step_priorities)
from repro_torch.core.transport.coupling import (
    AxisSchedules, DropSchedule, LatencyTail, PrioritySchedules,
    closed_form_schedule,
    priority_schedules_from_round_stats, schedule_from_engine,
    schedule_from_round_stats, split_schedule_from_engine,
    split_schedule_from_round_stats)
from repro_torch.core.transport.telemetry import (
    CAUSES, COMPONENTS, ConservationError, DesignRecord, DropProvenance,
    TraceRecorder, audit_round, provenance_from_record, provenance_heuristic)
from repro_torch.core.transport.trace_export import (
    iter_trace_events, to_trace_events, validate_events, validate_trace,
    write_trace)

__all__ = [
    "SimParams", "NetworkParams", "DcqcnParams", "ReliabilityParams",
    "WorkloadParams", "TopologyParams", "WindowPolicy", "FaultParams",
    "BatchedEngine", "BatchedSimParams", "RoundStats", "SweepResult",
    "sweep", "CollectiveSimulator", "DESIGNS", "TIERS", "hier_params",
    "hier_protocol", "layer_priorities", "make_plan", "with_step_priorities",
    "AxisSchedules", "DropSchedule", "LatencyTail", "PrioritySchedules",
    "closed_form_schedule",
    "priority_schedules_from_round_stats", "schedule_from_engine",
    "schedule_from_round_stats", "split_schedule_from_engine",
    "split_schedule_from_round_stats",
    "CAUSES", "COMPONENTS", "ConservationError", "DesignRecord",
    "DropProvenance", "TraceRecorder", "audit_round",
    "provenance_from_record", "provenance_heuristic",
    "iter_trace_events", "to_trace_events", "validate_events",
    "validate_trace", "write_trace",
]
