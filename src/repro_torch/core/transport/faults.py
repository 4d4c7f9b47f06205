"""Seeded fault injection (port of ``repro/core/transport/faults.py``).

The :class:`~repro_torch.core.transport.params.FaultParams` processes
become per-``(step, node)`` availability masks, drawn on the host block
by block from their own substreams (140+) and carried across blocks in
:class:`FaultState`, exactly as the numpy engine draws them: this module
consumes random streams, so it is numpy, copied as it is.  A fault
stream is drawn only when its rate is nonzero.

- **Stall / crash with restart**: Bernoulli starts per node-step,
  resolved to "steps since the last start" by a running max; a node is
  down while that is below the duration.  A crash without restart stays
  down.
- **Link flap**: a 2-state Markov chain per ToR uplink (and per DCI
  uplink on multi-pod fabrics), in closed form.
- **Rail failure**: one draw per round; it blocks the cross-pod flows
  whose sender's rank is the failed rail.
- **Slow-NIC straggler**: a static seeded node subset whose send rate is
  scaled by ``1 / straggler_slowdown`` (not counted in ``fault_flows``).

:func:`apply_to_result` is the design reaction, written once for numpy
arrays and torch tensors (the device core calls it): a blocked flow
times out and is resent by the reliable designs (twice the time plus the
detection timeout) and is cut by Celeris (nothing delivered); a dead
flow costs the reliable designs the whole retry budget and delivers
nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.transport import network
from repro_torch.core.transport.params import FaultParams, SimParams

# Fault substreams (the numpy engine's ids).
STREAM_STALL = 140
STREAM_CRASH = 141
STREAM_FLAP = 142
STREAM_FLAP_DCI = 143
STREAM_RAIL = 144
STREAM_STRAGGLER = 145

# "never started" sentinel for the running-max outage scans
_NEVER = np.iinfo(np.int64).min // 2


@dataclasses.dataclass
class FaultState:
    """Fault-process state carried across round blocks."""
    stall_last: np.ndarray | None = None    # (n,) last stall-start step
    crash_last: np.ndarray | None = None    # (n,) last crash-start step
    flap_down: np.ndarray | None = None     # (n_tors,) link down?
    flap_down_dci: np.ndarray | None = None  # (n_pods,) DCI link down?


@dataclasses.dataclass
class BlockFaults:
    """Availability masks for one round block (``tb`` steps)."""
    node_blocked: np.ndarray | None  # (tb, n) stalled (recoverable outage)
    node_dead: np.ndarray | None     # (tb, n) crashed (no data ever)
    tor_down: np.ndarray | None      # (tb, n_tors) uplink flapped down
    dci_down: np.ndarray | None      # (tb, n_pods) DCI uplink down
    rail_down: np.ndarray | None     # (tb,) failed-rail round?

    @property
    def any(self) -> bool:
        return any(m is not None for m in
                   (self.node_blocked, self.node_dead, self.tor_down,
                    self.dci_down, self.rail_down))


def _outage_scan(gen, rate, duration, t0, tb, n, last, targets):
    """(down, new_last): duration-``duration`` outages from per-step
    Bernoulli starts, resolved for the whole block at once; ``last``
    carries the latest start step per node across blocks and
    ``duration=None`` means permanent."""
    t_idx = t0 + np.arange(tb)
    starts = gen.random((tb, n)) < rate
    if targets is not None:
        mask = np.zeros(n, dtype=bool)
        mask[list(targets)] = True
        starts &= mask[None, :]
    last_start = np.maximum.accumulate(
        np.where(starts, t_idx[:, None], _NEVER), axis=0)
    last_start = np.maximum(last_start, last[None, :])
    if duration is None:
        down = last_start > _NEVER
    else:
        down = (t_idx[:, None] - last_start) < duration
    return down, last_start[-1].copy()


class FaultModel:
    """One seed's failure scenario, block by block: construct once per
    trace pass (only when ``params.fault.active``), call :meth:`advance`
    once per round block in step order, then :meth:`phase_masks` per
    schedule phase."""

    def __init__(self, p: SimParams, seed: int, n: int, n_tors: int,
                 steps_per_round: int):
        self.fp: FaultParams = p.fault
        self.n = n
        self.steps = steps_per_round
        self.n_pods = p.topo.n_pods if p.topo.hierarchical else 0
        fp = self.fp
        self._stall_gen = (np.random.default_rng([seed, STREAM_STALL])
                           if fp.stall_rate > 0 else None)
        self._crash_gen = (np.random.default_rng([seed, STREAM_CRASH])
                           if fp.crash_rate > 0 else None)
        self._flap_gen = (np.random.default_rng([seed, STREAM_FLAP])
                          if fp.flap_rate > 0 else None)
        self._flap_dci_gen = (np.random.default_rng([seed, STREAM_FLAP_DCI])
                              if fp.flap_rate > 0 and self.n_pods else None)
        self._rail_gen = (np.random.default_rng([seed, STREAM_RAIL])
                          if fp.rail_fail_rate > 0 else None)
        self.state = FaultState(
            stall_last=(np.full(n, _NEVER) if self._stall_gen is not None
                        else None),
            crash_last=(np.full(n, _NEVER) if self._crash_gen is not None
                        else None),
            flap_down=(np.zeros(n_tors, dtype=bool)
                       if self._flap_gen is not None else None),
            flap_down_dci=(np.zeros(self.n_pods, dtype=bool)
                           if self._flap_dci_gen is not None else None))
        self.n_tors = n_tors
        # static slow-NIC subset: rate scale per node, drawn once
        self.rate_scale = None
        if fp.straggler_frac > 0:
            gen = np.random.default_rng([seed, STREAM_STRAGGLER])
            pool = (np.asarray(fp.target_nodes)
                    if fp.target_nodes is not None else np.arange(n))
            k = max(1, int(round(fp.straggler_frac * pool.size)))
            slow = gen.choice(pool, size=min(k, pool.size), replace=False)
            self.rate_scale = np.ones(n, dtype=np.float32)
            self.rate_scale[slow] = 1.0 / fp.straggler_slowdown

    def advance(self, t0: int, tb: int) -> BlockFaults:
        """Availability masks for steps ``[t0, t0 + tb)``."""
        fp, st = self.fp, self.state
        blocked = dead = tor_down = dci_down = rail_down = None
        if self._stall_gen is not None:
            blocked, st.stall_last = _outage_scan(
                self._stall_gen, fp.stall_rate, fp.stall_steps, t0, tb,
                self.n, st.stall_last, fp.target_nodes)
        if self._crash_gen is not None:
            dur = fp.crash_restart_steps or None
            dead, st.crash_last = _outage_scan(
                self._crash_gen, fp.crash_rate, dur, t0, tb, self.n,
                st.crash_last, fp.target_nodes)
        if self._flap_gen is not None:
            u = self._flap_gen.random((tb, 2, self.n_tors))
            tor_down = network._markov_burst(
                st.flap_down, u[:, 0] < fp.flap_rate,
                u[:, 1] < fp.flap_recover_prob)
            st.flap_down = tor_down[-1].copy()
        if self._flap_dci_gen is not None:
            u = self._flap_dci_gen.random((tb, 2, self.n_pods))
            dci_down = network._markov_burst(
                st.flap_down_dci, u[:, 0] < fp.flap_rate,
                u[:, 1] < fp.flap_recover_prob)
            st.flap_down_dci = dci_down[-1].copy()
        if self._rail_gen is not None:
            n_rounds = tb // self.steps
            fails = self._rail_gen.random(n_rounds) < fp.rail_fail_rate
            rail_down = np.repeat(fails, self.steps)
        return BlockFaults(node_blocked=blocked, node_dead=dead,
                           tor_down=tor_down, dci_down=dci_down,
                           rail_down=rail_down)

    def phase_masks(self, blk: BlockFaults, rows: np.ndarray, ph, hg,
                    nodes_per_tor: int):
        """(blocked, dead) ``(n_rows, n_flows)`` masks for one phase (None
        where empty): a flow is hit when either endpoint's NIC, ToR
        uplink or (cross-pod) DCI uplink is down, or its rail failed;
        ``dead`` wins over ``blocked``."""
        if not blk.any:
            return None, None
        src, dst = ph.src, ph.dst
        n_rows = rows.size
        blocked = np.zeros((n_rows, src.size), dtype=bool)
        dead = np.zeros((n_rows, src.size), dtype=bool)
        if blk.node_blocked is not None:
            nb = blk.node_blocked[rows]
            blocked |= nb[:, src] | nb[:, dst]
        if blk.node_dead is not None:
            nd = blk.node_dead[rows]
            dead |= nd[:, src] | nd[:, dst]
        if blk.tor_down is not None:
            td = blk.tor_down[rows]
            blocked |= (td[:, src // nodes_per_tor]
                        | td[:, dst // nodes_per_tor])
        if blk.dci_down is not None and hg.cross.size:
            dd = blk.dci_down[rows]
            x = hg.cross
            blocked[:, x] |= (dd[:, hg.src_pod[x]] | dd[:, hg.dst_pod[x]])
        if blk.rail_down is not None and self.n_pods and hg.cross.size:
            m = self.n // self.n_pods
            x = hg.cross
            on_rail = x[(src[x] % m) == (self.fp.rail % m)]
            if on_rail.size:
                blocked[:, on_rail] |= blk.rail_down[rows, None]
        blocked &= ~dead
        if not blocked.any():
            blocked = None
        if not dead.any():
            dead = None
        return blocked, dead


def apply_to_result(design: str, time_us, delivered, blocked, dead, rel,
                    parts: dict | None = None,
                    offered: float | None = None):
    """One phase's fault masks on its float32 completion times and
    delivered packets; returns ``(time_us, delivered)``.

    numpy arrays or torch tensors (``where`` of the arrays' own library);
    ``blocked``/``dead`` may be None.  The arithmetic is the numpy
    engine's in-place updates: float32 throughout, ``blocked`` and
    ``dead`` disjoint.  The reliable designs' delivered packets are
    returned unchanged: they are the live flows' offer, which the engine
    counts from ``dead`` alone.

    ``parts`` is the flight recorder's scratchpad: when a dict is passed,
    the exact float64 deltas this overlay applies are recorded in it,
    ``"fault"`` the added completion time and ``"fault_lost"`` the
    packets a fault swallowed (a dead reliable flow loses its
    ``offered`` packets, which ``parts`` requires), read from the state
    before the overlay.  The returned times and packets are the same with
    or without it.
    """
    is_torch = isinstance(time_us, torch.Tensor)
    where = torch.where if is_torch else np.where
    if parts is not None and offered is None:
        raise ValueError("parts= records fault-lost packets: pass offered=, "
                         "the packets each flow offers")
    det = {"roce": rel.rto_us, "irn": rel.rto_low_us,
           "srnic": rel.rto_low_us + rel.host_slowpath_us}.get(design)
    if parts is not None:
        f64 = ((lambda a: a.double()) if is_torch
               else (lambda a: np.asarray(a, np.float64)))
        zero = (torch.zeros_like(time_us, dtype=torch.float64) if is_torch
                else np.zeros(np.shape(time_us)))
        if design == "celeris":
            gone = zero
            for m in (blocked, dead):
                if m is not None:
                    gone = where(m, f64(delivered), gone)
            parts["fault"], parts["fault_lost"] = zero, gone
        else:
            add = zero
            if dead is not None:
                add = where(dead, det * (1 + rel.max_retries), add)
                parts["fault_lost"] = where(dead, float(offered), zero)
            else:
                parts["fault_lost"] = zero
            if blocked is not None:
                add = where(blocked, f64(time_us) + det, add)
            parts["fault"] = add
    if design == "celeris":
        for m in (blocked, dead):
            if m is not None:
                delivered = where(m, 0.0, delivered)
        return time_us, delivered
    # the reliable design's retransmission timeout notices the outage;
    # each constant is rounded to float32 as the numpy engine's is
    if blocked is not None:
        time_us = where(blocked, 2.0 * time_us + float(np.float32(det)),
                        time_us)
    if dead is not None:
        time_us = where(dead, time_us + float(np.float32(
            det * (1 + rel.max_retries))), time_us)
    return time_us, delivered
