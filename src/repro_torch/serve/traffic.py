"""Request-driven serving traffic over the lossy transport (port of
``repro/serve/traffic.py``: numpy on the host, as in the JAX package;
its engine runs on the port's device).

The "millions of users" workload: a disaggregated serving mesh where
``n_prefill`` prefill nodes compute KV caches and ship them, block by
block, into a small pod of ``n_decode`` decode nodes.  Many senders per
receiver is an **incast** pattern — the transport engine charges it
with per-receiver contention (see ``core/transport/schedule.py``), and
each NIC design reacts in character: RoCE/IRN retransmit into the
congested decode ports, Celeris's bounded window cuts late KV blocks
and the Hadamard-coded KV path (``core/coding.py``) recovers them.

Three layers, all seeded and engine-compatible:

1. :func:`kv_flow_plan` — the static per-round transfer plan: every
   prefill node drives one flow into its (round-robin) decode target,
   ``steps_per_round`` blocks of ``kv_block_bytes`` per round.  Static
   flows are what keeps the engine's ``(step, flow)`` vectorization —
   the *request* dynamics live in the queue simulation, not the plan.
2. :func:`request_trace` — an open-loop Poisson request process:
   exponential inter-arrivals at a rate set by ``load`` (offered KV
   bytes as a fraction of the plan's shipping capacity), log-normal
   prefill lengths, geometric decode lengths.  Open-loop means the
   arrival *times* are design-independent: a slow transport design
   does not throttle users, it accumulates backlog.
3. :func:`simulate_serving` — FIFO block shipping over the engine's
   per-round times: each round moves up to ``capacity_blocks_per_round``
   blocks, a request's KV is complete when its last block's round
   ends, and its delivered KV fraction is the shipped-block-weighted
   mean of the rounds' ``recv_frac`` (Celeris window cuts surface
   here; ``coupling.kv_hole_masks`` turns the fraction into per-wire-row
   hole masks that ``serve_step.degrade_caches`` applies to real
   decoders).

Token latency is time-to-first-decode-token: queueing + KV transfer
(+ a constant prefill-compute term), the serving-SLO quantity fig8
sweeps against load and design.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.transport import schedule as schedule_mod
from repro_torch.core.transport import telemetry
from repro_torch.core.transport.params import NetworkParams

# seeded substreams (engine streams live in 100-150; serve traffic gets
# its own block so plans and request processes never share draws)
STREAM_ARRIVALS = 160
STREAM_LENGTHS = 161
STREAM_KV_HOLES = 162      # consumed by coupling.kv_hole_masks


@dataclasses.dataclass(frozen=True)
class ServeTrafficParams:
    """The disaggregated serving scenario's static knobs.

    ``load`` is the offered-load fraction: mean KV bytes arriving per
    microsecond over the plan's shipping capacity at the reference
    round time (see :func:`arrival_rate_per_us`).  Open-loop, so
    load > ~1 is allowed and means unbounded backlog growth.
    """
    n_prefill: int = 28
    n_decode: int = 4
    steps_per_round: int = 8          # KV blocks per prefill flow per round
    kv_block_bytes: int = 1 << 20
    kv_bytes_per_token: int = 32 << 10
    prefill_tokens_mean: float = 512.0
    prefill_tokens_sigma: float = 0.5   # log-space sigma of the lognormal
    decode_tokens_mean: float = 128.0   # geometric mean decode length
    prefill_us_per_token: float = 0.3   # prefill compute before shipping
    load: float = 0.7

    @property
    def n_nodes(self) -> int:
        return self.n_prefill + self.n_decode

    @property
    def fan_in(self) -> int:
        """Concurrent senders per decode node (ceil of the ratio)."""
        return -(-self.n_prefill // self.n_decode)

    @property
    def capacity_blocks_per_round(self) -> int:
        """KV blocks the plan can ship per round (all flows, all steps)."""
        return self.n_prefill * self.steps_per_round

    @property
    def mean_request_blocks(self) -> float:
        """Mean KV blocks per request (lognormal mean x bytes/token)."""
        mean_bytes = self.prefill_tokens_mean * self.kv_bytes_per_token
        return mean_bytes / self.kv_block_bytes


def kv_flow_plan(tp: ServeTrafficParams) -> schedule_mod.FlowPlan:
    """The static prefill→decode incast plan the engine times.

    One phase: prefill node ``i`` drives decode node ``i % n_decode``
    (nodes ``n_prefill ..`` in the fabric), ``steps_per_round`` steps of
    one ``kv_block_bytes`` block each.  With ``n_prefill > n_decode``
    every decode port takes ``~fan_in`` concurrent senders — the incast
    case of :func:`repro_torch.core.transport.schedule.flow_plan`.

    Steps carry per-step priorities (pure assemble-time metadata — the
    physics trace and the default ``cut_order="arrival"`` stats are
    unchanged): the head half of each request's KV blocks is class 1
    (the prompt prefix decode needs first — losing it stalls the first
    token) and the tail half class 0 (late-context blocks the coded KV
    path recovers most cheaply).  Under ``cut_order="priority"`` the
    bounded window then cuts tail blocks first.
    """
    src = np.arange(tp.n_prefill)
    dst = tp.n_prefill + (src % tp.n_decode)
    kv = schedule_mod.SchedulePhase(
        name="kv", src=src, dst=dst, n_steps=tp.steps_per_round,
        payload_bytes=tp.kv_block_bytes)
    plan = schedule_mod.flow_plan("kv_incast", (kv,))
    head = (np.arange(tp.steps_per_round)
            < (tp.steps_per_round + 1) // 2).astype(int)
    return schedule_mod.with_step_priorities(plan, head)


def serve_net_params(tp: ServeTrafficParams, base: NetworkParams | None = None
                     ) -> NetworkParams:
    """Fabric sized for the serving mesh (prefill + decode nodes)."""
    base = base or NetworkParams()
    npt = base.nodes_per_tor
    if tp.n_nodes % npt:
        # shrink the ToR to the largest divisor of the mesh size
        npt = max(d for d in range(1, npt + 1) if tp.n_nodes % d == 0)
    return dataclasses.replace(base, n_nodes=tp.n_nodes, nodes_per_tor=npt)


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """One seeded open-loop request process (design-independent)."""
    arrival_us: np.ndarray      # (n_req,) sorted arrival times
    ready_us: np.ndarray        # (n_req,) arrival + prefill compute
    kv_blocks: np.ndarray       # (n_req,) int, KV blocks to ship
    decode_tokens: np.ndarray   # (n_req,) int, response length

    @property
    def n_requests(self) -> int:
        return self.arrival_us.size


def arrival_rate_per_us(tp: ServeTrafficParams, ref_round_us: float) -> float:
    """Requests per microsecond hitting ``load``.

    Capacity is ``capacity_blocks_per_round`` per ``ref_round_us``
    (the *reference* round time — fig8 uses the unloaded nominal, so
    every design faces the same arrival process and the slow ones eat
    the backlog).
    """
    cap_blocks_per_us = tp.capacity_blocks_per_round / ref_round_us
    return tp.load * cap_blocks_per_us / tp.mean_request_blocks


def request_trace(tp: ServeTrafficParams, horizon_us: float,
                  ref_round_us: float, seed: int) -> RequestTrace:
    """Draw the request process covering ``[0, horizon_us)``."""
    rate = arrival_rate_per_us(tp, ref_round_us)
    rng_a = np.random.default_rng([seed, STREAM_ARRIVALS])
    rng_l = np.random.default_rng([seed, STREAM_LENGTHS])
    # exponential gaps until past the horizon (draw in chunks)
    gaps, t = [], 0.0
    while t < horizon_us:
        chunk = rng_a.exponential(1.0 / rate, size=256)
        gaps.append(chunk)
        t += float(chunk.sum())
    arrival = np.cumsum(np.concatenate(gaps))
    arrival = arrival[arrival < horizon_us]
    n = arrival.size
    mu = np.log(tp.prefill_tokens_mean) - tp.prefill_tokens_sigma ** 2 / 2
    prefill_tokens = np.maximum(
        1, rng_l.lognormal(mu, tp.prefill_tokens_sigma, n)).astype(int)
    kv_blocks = np.maximum(1, np.ceil(
        prefill_tokens * tp.kv_bytes_per_token / tp.kv_block_bytes)).astype(int)
    decode_tokens = 1 + rng_l.geometric(
        1.0 / max(tp.decode_tokens_mean, 1.0), n)
    return RequestTrace(
        arrival_us=arrival,
        ready_us=arrival + prefill_tokens * tp.prefill_us_per_token,
        kv_blocks=kv_blocks, decode_tokens=decode_tokens)


@dataclasses.dataclass(frozen=True)
class ServingResult:
    """Per-request outcomes of one design's rounds serving one trace.

    ``kv_loss_by_cause`` (present when ``simulate_serving`` was given
    per-cause loss rates) splits each request's missing KV fraction by
    originating cause (``telemetry.CAUSES`` order: wire_drop, fault,
    window_cut), shipped-block-weighted exactly like ``kv_frac`` — the
    serve side of the end-to-end drop-provenance chain.
    """
    latency_us: np.ndarray      # (n_req,) time-to-first-decode-token
    completed: np.ndarray       # (n_req,) bool — KV fully shipped in horizon
    kv_frac: np.ndarray         # (n_req,) delivered KV fraction (<= 1)
    blocks_shipped: int         # total blocks moved (conservation checks)
    kv_loss_by_cause: np.ndarray | None = None   # (n_req, n_causes)

    @property
    def p99_latency_us(self) -> float:
        return float(np.percentile(self.latency_us, 99))

    @property
    def completion_frac(self) -> float:
        return float(self.completed.mean()) if self.completed.size else 1.0

    @property
    def mean_kv_frac(self) -> float:
        done = self.kv_frac[self.completed]
        return float(done.mean()) if done.size else 1.0

    def loss_attribution(self) -> dict:
        """Mean lost-KV fraction by cause over completed requests
        (empty dict when causes were not supplied)."""
        if self.kv_loss_by_cause is None:
            return {}
        rows = self.kv_loss_by_cause[self.completed]
        if not rows.size:
            return {c: 0.0 for c in telemetry.CAUSES}
        return {c: float(rows[:, i].mean())
                for i, c in enumerate(telemetry.CAUSES)}


def simulate_serving(tp: ServeTrafficParams, times_us: np.ndarray,
                     recv_frac: np.ndarray, trace: RequestTrace,
                     loss_rates: np.ndarray | None = None
                     ) -> ServingResult:
    """FIFO KV shipping over one design's engine rounds.

    Round ``r`` (ending at ``T[r] = cumsum(times_us)[r]``) ships up to
    ``capacity_blocks_per_round`` blocks from requests whose prefill
    finished before the round started, oldest-ready first; a request's
    first decode token fires at the end of the round carrying its last
    block.  ``recv_frac[r]`` is the fraction of round ``r``'s packets
    that beat the window (1.0 for the reliable designs) — a request's
    delivered KV fraction is the block-weighted mean over its rounds.

    Requests whose KV is still queued when the horizon ends are
    *censored*: ``completed=False`` and their latency is the (lower
    bound) horizon remainder — report completion_frac next to any
    latency percentile at loads near 1.

    ``loss_rates`` (optional, ``(R, n_causes)`` — per-round lost
    payload fraction by cause from the engine run that produced
    ``times_us``/``recv_frac``, ``telemetry.DesignRecord.loss_rates()``
    of a recorded run) additionally attributes every request's missing KV to its
    originating cause with the same shipped-block weighting, so a
    degraded cache can be traced back to a DCI fault stall or a window
    cut.  Rounds beyond the rates' length wrap, like DropSchedule.
    """
    T_end = np.cumsum(times_us)
    R = times_us.size
    n = trace.n_requests
    order = np.argsort(trace.ready_us, kind="stable")
    latency = np.zeros(n)
    kv_got = np.zeros(n)
    lr = None
    if loss_rates is not None:
        lr = np.asarray(loss_rates, np.float64)
        kv_lost = np.zeros((n, lr.shape[1]))
    done = np.zeros(n, dtype=bool)
    cap = tp.capacity_blocks_per_round
    shipped_total = 0
    head = 0                       # next request not yet fully shipped
    remaining = trace.kv_blocks.astype(np.int64).copy()
    for r in range(R):
        t_start = T_end[r - 1] if r else 0.0
        budget = cap
        i = head
        while budget > 0 and i < n:
            j = order[i]
            if trace.ready_us[j] > t_start:
                break              # FIFO by ready time: later ones wait
            ship = min(budget, int(remaining[j]))
            if ship > 0:
                remaining[j] -= ship
                budget -= ship
                shipped_total += ship
                kv_got[j] += ship * recv_frac[r]
                if lr is not None:
                    kv_lost[j] += ship * lr[r % lr.shape[0]]
                if remaining[j] == 0:
                    done[j] = True
                    latency[j] = T_end[r] - trace.arrival_us[j]
            if remaining[j] == 0:
                if i == head:
                    head += 1
                i += 1
            else:
                break              # this round's capacity is exhausted
    horizon = T_end[-1] if R else 0.0
    censored = ~done
    latency[censored] = np.maximum(
        horizon - trace.arrival_us[censored], 0.0)
    kv_frac = np.where(trace.kv_blocks > 0,
                       kv_got / np.maximum(trace.kv_blocks, 1), 1.0)
    by_cause = None
    if lr is not None:
        by_cause = np.clip(
            kv_lost / np.maximum(trace.kv_blocks, 1)[:, None], 0.0, 1.0)
    return ServingResult(latency_us=latency, completed=done,
                         kv_frac=np.clip(kv_frac, 0.0, 1.0),
                         blocks_shipped=shipped_total,
                         kv_loss_by_cause=by_cause)


def nominal_round_us(tp: ServeTrafficParams, net: NetworkParams) -> float:
    """Unloaded reference round time for the KV plan.

    Per step, a block serializes behind ``fan_in - 1`` other senders on
    the decode port (the incast overlay's egress share), plus the
    half-RTT floor.  This is the load-normalization reference and the
    scale the Celeris serving SLO budget is set from — *not* a
    prediction of loaded round times.
    """
    per_step = (tp.kv_block_bytes / net.link_bytes_per_us * tp.fan_in
                + net.base_rtt_us / 2)
    return tp.steps_per_round * per_step
