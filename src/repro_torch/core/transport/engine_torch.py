"""The engine's device backend in torch (port of
``repro/core/transport/engine_jax.py``: flat and hierarchical fabrics,
the ring, ``hier`` and ``perrail`` schedules, arbitrary flow plans with
the incast overlay, fault injection; and of the numpy engine's
legacy-stream pass, ``_traces_legacy``).

The numpy engine (``repro.core.transport.engine``) is the reference:
every seeded statistic is defined by its exact draw order.  This module
keeps that order and moves the rate-dependent physics to the card.

Hybrid split (the replay contract decides what goes where)
----------------------------------------------------------
Everything that *consumes a random substream* stays on the host in
numpy, block for block and phase by phase in the numpy engine's exact
order (``BatchedEngine._traces_shared`` there): the ToR and DCI burst
chains, then per phase the hot-row ECN/drop curves, the DCI overlay of
the curves, the CNP draws (the flat stream, then the DCI stream on
cross-pod columns, then the incast stream on every row of the incast
columns, whose occupancy is floored at ``1 - 1/fan``); then the fault
masks (``faults.FaultModel``), and per design and phase the PFC cascade
and the loss draws (the shared helpers in :mod:`designs`).  Loss draws depend only on the drop curve,
never on the DCQCN rate, so each design's recovery machinery reduces to
dense rate-independent fields::

    excess_time = A + B * pkt_time        (reliable designs)
    delivered   = n_pkts - wire_losses    (celeris)

Everything *rate-dependent* runs as torch ops on the engine's device,
with the seed axis written out as the leading dimension: the DCQCN
recurrence over the whole ``(S, tb, n)`` block of marks (one launch of
the hand-written scan kernel per block, ``kernels/csrc/dcqcn.cu``; its
plain version on the CPU), so each sender NIC's rate evolves across
phase boundaries; then per phase a gather of its rows and sender
columns, the queue/bandwidth response curves (one formula source:
:mod:`network`), the DCI overlay as static column vectors
(``topology.dci_columns``), the incast share of the receiver's egress
(the effective rate divided by the fan-in, a float32 tensor of fans:
the IEEE quotient numpy's ``float32 /= int64`` rounds to), the straggler
rate scale, per-design completion times, the fault reactions
(``faults.apply_to_result``) and the per-step tier and pod reductions.
The float types follow the numpy engine: float32 times, float64 where it
casts (the excess ``A + B * pkt_time``).

Two opt-in outputs ride the same core and copy back only when asked
for: the per-flow times and delivered packets of the designs in
``per_node_for`` (the per-step window's input, scattered into ``(T,
n)`` host arrays by sender column), and the flight recorder's
reductions (:func:`_record_reduce`: per step the critical flow and its
time components, per tier the component sums and the delivered,
wire-lost and fault-lost packets, all reduced on the device).  Neither
adds anything to the tensors the times and delivered packets come from.

Legacy streams
--------------
:func:`traces_legacy` is the numpy engine's ``_traces_legacy`` split the
same way.  The host pass (:func:`_legacy_host`) consumes its streams in
its order: the clean fabric trace (irn/srnic/celeris), RoCE's
PFC-polluted one (``network.roce_fabric_trace``), the path curves, the
replayed selective-repeat and celeris draws (``replay``), RoCE's CNP
marks on its hot rows and its engine-native transfer draws (the ``A +
B * pkt_time`` split above).  The device core (:func:`_legacy_core`)
makes one scan call over the stacked CNP channels, roce, then sr
(irn/srnic), then celeris, only those asked for, with the step mask
``any_t`` the OR over every channel and flow (the numpy ``rate_trace``
materializes every flow of every channel at such a step), then each
design's times in the numpy engine's float order.

Tolerance contract
------------------
The host pass replays the numpy engine's streams exactly, so both see
the same draws: delivered packets and faulted-flow counts agree exactly.
The core regroups a few float accumulations (the A/B split above,
``occ ** 3`` as two multiplies, the ``pow`` of the alpha decay),
leaving relative differences near 1e-7 on step times: the contract is
rtol 1e-5 on times, p99 and delivered fractions, as for ``engine_jax``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.transport import (designs, faults, network, replay,
                                        telemetry, topology)
from repro_torch.core.transport import engine as engine_mod
from repro_torch.core.transport.dcqcn import DcqcnState
from repro_torch.kernels import ops


class _SeedStreams:
    """One seed's generators and carried chain states, consumed block by
    block in the numpy engine's exact order (the replay contract)."""

    def __init__(self, eng, seed: int, design_list, incast: bool):
        p = eng.p
        g = eng._geometry(seed)
        net = p.net
        n, n_tors = g["n"], g["n_tors"]
        self.fabric_gen = np.random.default_rng(g["fabric_seed"])
        self.cnp_gen = np.random.default_rng([seed, engine_mod._STREAM_CNP])
        self.pfc_gen = np.random.default_rng([seed, engine_mod._STREAM_PFC])
        self.transfer_gens = {
            d: np.random.default_rng(
                [seed, engine_mod._STREAM_TRANSFER[d]])
            for d in design_list}
        self.fab_state = network.FabricState(
            bursting=np.zeros(n_tors, dtype=bool),
            occupancy=np.full(n_tors, net.idle_occupancy))
        if p.topo.hierarchical:
            self.dci_state = topology.init_dci_state(net, p.topo)
            self.dci_fab_gen = np.random.default_rng(
                [g["fabric_seed"], topology.STREAM_DCI_FABRIC])
            self.dci_cnp_gen = np.random.default_rng(
                [seed, topology.STREAM_DCI_CNP])
        if incast:
            self.inc_cnp_gen = np.random.default_rng(
                [seed, engine_mod._STREAM_INCAST_CNP])
        self.fmodel = (faults.FaultModel(p, seed, n, n_tors, g["steps"])
                       if p.fault.active else None)


class _Plan:
    """The static per-phase facts of one engine configuration: rows in a
    round, senders, tier and pod columns, packets, the incast columns and
    their fan-in, and the DCI overlay vectors (numpy, and as tensors on
    the engine's device)."""

    def __init__(self, eng):
        p = eng.p
        net, topo = p.net, p.topo
        g = eng._geometry(0)
        self.n, self.steps, self.n_tors = g["n"], g["steps"], g["n_tors"]
        self.plan = plan = g["plan"]
        self.hgs = plan.geometries(net, topo)
        self.hier = topo.hierarchical
        self.single = plan.single_phase
        dev = eng.device

        def on_dev(a, dtype=torch.long):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        self.phases = []
        for k, (ph, hg) in enumerate(zip(plan.phases, self.hgs)):
            cols = topology.dci_columns(topo, hg)
            fan = ph.fan_in()
            inc = np.flatnonzero(fan > 1)
            self.phases.append(dict(
                rec=(self._recorder_facts(net, topo, hg, fan, inc, on_dev)
                     if eng.recorder is not None else None),
                inc=inc, fan=fan,
                fan_t=on_dev(fan, torch.float32) if inc.size else None,
                ph=ph, hg=hg, n_pkts=ph.n_pkts(net),
                steps=np.flatnonzero(plan.phase_of_step == k),
                all_senders=np.array_equal(ph.src, np.arange(self.n)),
                src_t=on_dev(ph.src),
                tier_np=hg.tier_cols,
                tier_t=[on_dev(c) for c in hg.tier_cols],
                pod_np=hg.pod_cols if self.hier else None,
                pod_t=([on_dev(c) for c in hg.pod_cols] if self.hier
                       else None),
                oversub_t=(on_dev(cols.oversub, torch.float32)
                           if cols is not None else None),
                dci_add_t=(on_dev(cols.dci_add, torch.float32)
                           if cols is not None else None)))

        # a collective schedule is a permutation: no incast column, no
        # incast stream, and the pass is the fan-in-1 engine's
        self.incast = any(s["inc"].size for s in self.phases)

    @staticmethod
    def _recorder_facts(net, topo, hg, fan, inc, on_dev) -> dict:
        """One phase's static inputs to the recorder's reductions: the
        flow→tier one-hot (float64, for the per-tier sums), the incast
        carve-out factor ``1 - 1/fan`` (float64, 0 off the incast
        columns) and the RTT component: the scalar half base RTT, or,
        where the DCI overlay adds its propagation to cross-pod columns,
        a float64 column vector and its per-tier sums (as the numpy
        engine promotes the scalar to an array there)."""
        n_flows = hg.src.size
        onehot = np.zeros((n_flows, topology.N_TIERS))
        for k, c in enumerate(hg.tier_cols):
            onehot[c, k] = 1.0
        carve = None
        if inc.size:
            carve = np.zeros(n_flows)
            carve[inc] = 1.0 - 1.0 / fan[inc]
        rtt_vec = rtt_tier = None
        if topo.hierarchical and hg.cross.size:
            rtt_vec = np.full(n_flows, float(net.base_rtt_us / 2))
            rtt_vec[hg.cross] += topo.dci_rtt_us / 2.0
            rtt_tier = np.array([rtt_vec[c].sum() for c in hg.tier_cols])
        return dict(
            onehot_t=on_dev(onehot, torch.float64),
            sizes=np.array([c.size for c in hg.tier_cols]),
            carve_t=None if carve is None else on_dev(carve, torch.float64),
            rtt_vec_t=(None if rtt_vec is None
                       else on_dev(rtt_vec, torch.float64)),
            rtt_tier=rtt_tier)

    def rows(self, k: int, tb: int) -> np.ndarray:
        """Phase ``k``'s steps in a block of ``tb`` steps, round-major."""
        round0 = np.arange(0, tb, self.steps)
        return (round0[:, None] + self.phases[k]["steps"][None, :]).ravel()


def _design_draws(d, n_pkts, drop_p, rel, net, rng, shape):
    """One design's loss draws over a block, reduced to dense
    rate-independent fields: ``A + B * pkt_time`` excess for the
    reliable designs, delivered packets for celeris.  Draw order and the
    drop-capable subset are exactly the numpy engine's."""
    if d == "celeris":
        deliv = np.full(shape, n_pkts, dtype=np.float32)
        idx = np.flatnonzero(drop_p > 0)
        if idx.size:
            pf = np.ascontiguousarray(drop_p).ravel()[idx]
            deliv.flat[idx] -= designs.celeris_loss_draws(n_pkts, pf, rng)
        return {"deliv": deliv}
    A = np.zeros(shape, dtype=np.float32)
    B = np.zeros(shape, dtype=np.float32)
    if d == "roce":
        p_eff = drop_p * designs.PFC_DROP_SUPPRESSION
        idx = np.flatnonzero(p_eff > 0)
        if idx.size:
            pf = np.ascontiguousarray(p_eff).ravel()[idx]
            a = np.zeros(idx.size)
            b = np.zeros(idx.size)
            for has_loss, n_resend, detect in designs.roce_loss_episodes(
                    n_pkts, pf, rel, net, rng):
                a += np.where(has_loss, detect, 0.0)
                b += np.where(has_loss, n_resend, 0.0)
            A.flat[idx] = a
            B.flat[idx] = b
    else:  # irn / srnic
        idx = np.flatnonzero(drop_p > 0)
        if idx.size:
            pf = np.ascontiguousarray(drop_p).ravel()[idx]
            k, tail_lost, k2 = designs.sr_loss_draws(n_pkts, pf, rng)
            detect = np.where(tail_lost, rel.rto_low_us,
                              rel.nack_delay_us + net.base_rtt_us)
            a = (np.where(k > 0, detect, 0.0)
                 + np.where(k2 > 0, rel.rto_low_us, 0.0))
            if d == "srnic":
                a += k * rel.host_slowpath_us
            b = np.where(k > 0, k, 0.0) + np.where(k2 > 0, k2, 0.0)
            A.flat[idx] = a
            B.flat[idx] = b
    return {"A": A, "B": B}


def _host_block(eng, st: _SeedStreams, ctx: _Plan, t0: int, tb: int,
                design_list):
    """One seed's draw pass for steps ``[t0, t0 + tb)``: exactly the
    numpy engine's stream consumption, minus the rate-dependent math the
    core does.  Returns the block's CNP marks ``(tb, n)``, per phase its
    inputs to the core, the faulted-flow count per step (None without
    faults) and, with a recorder, per phase its rows and fabric
    counters."""
    p = eng.p
    net, rel, topo = p.net, p.rel, p.topo
    u = st.fabric_gen.random((tb, network._ADVANCE_DRAWS, ctx.n_tors))
    _, occ_tor, st.fab_state = network.occupancy_trace(net, u, st.fab_state)
    if ctx.hier:
        u_dci = st.dci_fab_gen.random(
            (tb, network._ADVANCE_DRAWS, topo.n_pods))
        _, occ_dci, st.dci_state = network.occupancy_trace(
            topology.dci_net_params(net, topo), u_dci, st.dci_state)

    # phase pass 1: path curves, the DCI overlay of the curves, and the
    # CNP draws, phase by phase (the flat stream, then the DCI stream)
    cnp = np.zeros((tb, ctx.n), dtype=bool)
    ph_host = []
    for k, s in enumerate(ctx.phases):
        ph, hg = s["ph"], s["hg"]
        rows = ctx.rows(k, tb)
        occ_ph = occ_tor if ctx.single else occ_tor[rows]
        ecn_p, drop_p, hot = engine_mod._sparse_path_curves(
            net, occ_ph, ph.src, ph.dst)
        occ32 = network.path_occupancy_trace(
            net, occ_ph.astype(np.float32), ph.src, ph.dst)
        occ_eff = None
        if ctx.hier:
            occ_eff = topology.overlay_curves(
                net, topo, hg, occ_ph, occ_dci if ctx.single
                else occ_dci[rows], ecn_p, drop_p)
        cnp_ph = np.zeros((rows.size, ph.src.size), dtype=bool)
        cnp_ph[hot] = st.cnp_gen.random((hot.size, ph.src.size)) < ecn_p[hot]
        if ctx.hier:
            topology.dci_cnp_draws(hg, ecn_p, cnp_ph, st.dci_cnp_gen)
        inc = s["inc"]
        if inc.size:
            # the incast overlay: the receiver's egress port runs at >= 1 -
            # 1/fan occupancy whenever its fan senders offer load; the
            # curves, the marks (their own stream), and below the PFC and
            # loss draws see the raised occupancy
            occ_inc = np.maximum(occ32[:, inc],
                                 (1.0 - 1.0 / s["fan"][inc]
                                  ).astype(occ32.dtype))
            occ32[:, inc] = occ_inc
            ecn_inc = network.ecn_mark_prob(net, occ_inc)
            drop_p[:, inc] = network.drop_prob(net, occ_inc)
            cnp_ph[:, inc] = (st.inc_cnp_gen.random(occ_inc.shape)
                              < ecn_inc)
        cnp[np.ix_(rows, ph.src)] = cnp_ph
        ph_host.append({"rows": rows, "occ32": occ32, "drop": drop_p,
                        "occ_eff": occ_eff})

    # the fault masks (after the marks, as the numpy engine draws them
    # after its DCQCN pass), and the cross-pod columns' effective
    # occupancy, which the PFC draws below see
    blk = st.fmodel.advance(t0, tb) if st.fmodel is not None else None
    fault_flows = np.zeros(tb) if blk is not None else None
    for k, h in enumerate(ph_host):
        x = ctx.phases[k]["hg"].cross
        if ctx.hier and x.size:
            h["occ32"][:, x] = h["occ_eff"].astype(np.float32)
        if blk is not None:
            blocked, dead = st.fmodel.phase_masks(
                blk, h["rows"], ctx.phases[k]["ph"], ctx.phases[k]["hg"],
                net.nodes_per_tor)
            shape = h["occ32"].shape
            h["blocked"] = (blocked if blocked is not None
                            else np.zeros(shape, dtype=bool))
            h["dead"] = (dead if dead is not None
                         else np.zeros(shape, dtype=bool))
            fault_flows[h["rows"]] = (h["blocked"].sum(axis=1)
                                      + h["dead"].sum(axis=1))
    counters = None
    if eng.recorder is not None:
        # the design-independent fabric counters, over the occupancy the
        # PFC draws see (reductions only, no draws)
        counters = [(h["rows"], network.congestion_counters(
            net, h["occ32"], h["drop"])) for h in ph_host]

    # PFC + loss draws, design by design and phase by phase (the PFC
    # stream is consumed on the roce iterations only); pauses are
    # multiples of pfc_pause_us, exact in float32
    for d in design_list:
        for k, h in enumerate(ph_host):
            if d == "roce":
                h["pfc"] = network.pfc_pause_trace(
                    net, h["occ32"], st.pfc_gen).astype(np.float32)
            h[d] = _design_draws(d, ctx.phases[k]["n_pkts"], h["drop"], rel,
                                 net, st.transfer_gens[d], h["occ32"].shape)
    for h in ph_host:
        del h["rows"], h["drop"], h["occ_eff"]
    return {"cnp": cnp, "phases": ph_host, "fault_flows": fault_flows,
            "counters": counters}


def _core(eng, ctx: _Plan, inp, state: DcqcnState, design_list, tb: int,
          per_node_for=()):
    """The rate-dependent physics of one block, all seeds at once.

    ``inp`` holds ``(S, tb, n)`` marks and per phase ``(S, rows, flows)``
    tensors on the engine's device.  Returns per phase and design the
    per-step max completion time ``nat`` ``(S, rows)`` and, where they
    are not schedule constants, the delivered sums ``deliv``, ``tier``
    and ``pod``; for the designs in ``per_node_for`` the per-flow times
    ``node_t`` and delivered packets ``node_d`` (None where every flow
    delivers its offer); with a recorder, its reductions ``rec``
    (:func:`_record_reduce`); and the carried DCQCN state.
    """
    net, rel, dq = eng.p.net, eng.p.rel, eng.p.dcqcn
    cnp = inp["cnp"]
    rates, (r, t, a, g) = ops.dcqcn_scan(
        cnp, cnp.any(-1), state.rate, state.target, state.alpha,
        state.good_stages, dq)
    dev = rates.device
    rate_scale = inp.get("rate_scale")
    out = []
    for k, s in enumerate(ctx.phases):
        ph_in = inp["phases"][k]
        occ32 = ph_in["occ32"]
        # the phase's rows and sender columns of the block's rates
        if ctx.single and s["all_senders"]:
            rate_ph = rates
        else:
            rows = torch.as_tensor(ctx.rows(k, tb), device=dev)
            rate_ph = rates.index_select(1, rows)
            if not s["all_senders"]:
                rate_ph = rate_ph.index_select(2, s["src_t"])
        if s["oversub_t"] is not None:
            qd, eff = topology.overlay_rates(net, occ32, rate_ph,
                                             s["oversub_t"])
        else:
            qd = network.queue_delay_us(net, occ32)
            eff = rate_ph * network.avail_bandwidth(net, occ32)
        if s["fan_t"] is not None:
            # incast: fan senders share the receiver's one egress link
            eff = torch.div(eff, s["fan_t"])
        if rate_scale is not None:          # slow-NIC stragglers
            eff = eff * rate_scale.index_select(1, s["src_t"])[:, None, :]
        # torch.div, not ``c / eff``: the reflected operator multiplies by
        # the reciprocal, which is not the IEEE quotient numpy takes
        pkt_time = torch.div(eff.new_tensor(net.pkt_time_us),
                             torch.clamp(eff, min=1e-3))
        ptf64 = pkt_time.double()
        serialize = s["n_pkts"] * pkt_time
        blocked, dead = ph_in.get("blocked"), ph_in.get("dead")
        per_design = {}
        for d in design_list:
            deliv = ex = None
            if d == "celeris":
                times = (serialize + designs.CELERIS_QUEUE_OVERLAP * qd
                         + net.base_rtt_us / 2)
                deliv = ph_in[d]["deliv"]
            else:
                times = serialize + qd + net.base_rtt_us / 2
                if d == "roce":
                    times = times + ph_in["pfc"]
                ex = ph_in[d]["A"].double() + ph_in[d]["B"].double() * ptf64
                times = times + ex.float()
            if s["dci_add_t"] is not None:
                times = times + s["dci_add_t"]
            parts = {} if s["rec"] is not None else None
            deliv_pre = deliv
            if blocked is not None:
                times, deliv = faults.apply_to_result(
                    d, times, deliv, blocked, dead, rel, parts=parts,
                    offered=s["n_pkts"])
            o = {"nat": times.amax(-1)}
            if deliv is None and dead is not None:
                # reliable designs deliver what a live flow offers
                deliv = (~dead).double() * float(s["n_pkts"])
            if d in per_node_for:
                o["node_t"], o["node_d"] = times, deliv
            if parts is not None:
                o["rec"] = _record_reduce(
                    net, s, d, times, deliv, deliv_pre, serialize, qd,
                    ph_in.get("pfc") if d == "roce" else None, ex, parts)
            if deliv is not None:
                o["deliv"] = deliv.sum(-1)
                o["tier"] = torch.stack([deliv[..., c].sum(-1)
                                         for c in s["tier_t"]], -1)
                if s["pod_t"] is not None:
                    o["pod"] = torch.stack([deliv[..., c].sum(-1)
                                            for c in s["pod_t"]], -1)
            per_design[d] = o
        out.append(per_design)
    return out, DcqcnState(rate=r, target=t, alpha=a, good_stages=g)


def _record_reduce(net, s, d, times, deliv, deliv_pre, serialize, qd, pfc,
                   ex, parts) -> dict:
    """The flight recorder's per-step reductions of one (phase, design)
    block on the device (``telemetry.TraceRecorder.record_phase``'s
    inputs): the critical flow ``ar`` (the argmax of the very times whose
    max is ``nat``), its components ``crit`` ``(S, rows, C)``, the
    per-tier component sums ``tier`` ``(S, rows, n_tiers, C)`` and the
    per-tier delivered, wire-lost and fault-lost packets ``pkts`` ``(S,
    rows, n_tiers, 3)``, all float64.  Each float32 component is cast to
    float64 before it is summed, as the numpy engine's recorder casts
    it; a component the numpy engine keeps as a scalar is summed as
    ``value * flows``.  Reads only: nothing here feeds ``times``."""
    r = s["rec"]
    onehot = r["onehot_t"]
    ar = times.argmax(-1)
    ser = serialize.double()
    inc = 0.0
    if r["carve_t"] is not None:
        # incast carve-out: the (1 - 1/fan) share of the fan-x
        # serialization stretch is receiver egress contention
        inc = ser * r["carve_t"]
        ser = ser - inc
    queue = (designs.CELERIS_QUEUE_OVERLAP * qd if d == "celeris" else qd)
    comps = {"serialize": ser, "queue": queue.double(),
             "rtt": (r["rtt_vec_t"] if r["rtt_vec_t"] is not None
                     else float(net.base_rtt_us / 2)),
             "pfc": pfc.double() if pfc is not None else 0.0,
             "retransmit": ex if ex is not None else 0.0,
             "incast": inc, "fault": parts.get("fault", 0.0)}
    S, rows = ar.shape
    dev = times.device
    f64 = dict(dtype=torch.float64, device=dev)
    crit = torch.empty(S, rows, telemetry.N_COMPONENTS, **f64)
    tier = torch.empty(S, rows, topology.N_TIERS, telemetry.N_COMPONENTS,
                       **f64)
    for ci, name in enumerate(telemetry.COMPONENTS):
        a = comps[name]
        if not isinstance(a, torch.Tensor):
            crit[..., ci] = a
            tier[..., ci] = torch.as_tensor(a * r["sizes"], **f64)
        elif a.dim() == 1:                  # the DCI-promoted RTT column
            crit[..., ci] = a[ar]
            tier[..., ci] = torch.as_tensor(r["rtt_tier"], **f64)
        else:
            crit[..., ci] = a.gather(-1, ar[..., None])[..., 0]
            tier[..., ci] = a @ onehot
    npk = float(s["n_pkts"])
    got = deliv.double() if deliv is not None else None
    wire = (npk - deliv_pre.double()) if deliv_pre is not None else None
    lost = parts.get("fault_lost")
    pkts = torch.zeros(S, rows, topology.N_TIERS, 3, **f64)
    pkts[..., 0] = (got @ onehot if got is not None
                    else torch.as_tensor(npk * r["sizes"], **f64))
    if wire is not None:
        pkts[..., 1] = wire @ onehot
    if lost is not None:
        pkts[..., 2] = lost @ onehot
    return {"ar": ar, "crit": crit, "tier": tier, "pkts": pkts}


def _check_designs(eng, design_list) -> list:
    net = eng.p.net
    unknown = [d for d in design_list if d not in designs.DESIGNS]
    if unknown:
        raise ValueError(f"unknown design(s) {unknown}; "
                         f"choose from {designs.DESIGNS}")
    if net.n_nodes < net.nodes_per_tor or net.n_nodes % net.nodes_per_tor:
        raise ValueError(
            f"n_nodes={net.n_nodes} must be a positive multiple of "
            f"nodes_per_tor={net.nodes_per_tor}")
    if net.ecn_threshold > net.loss_knee:
        # the hot-row prescreen in _sparse_path_curves keys on the ECN
        # threshold being the lower of the two curves
        raise ValueError(
            f"ecn_threshold={net.ecn_threshold} must not exceed "
            f"loss_knee={net.loss_knee}")
    return list(design_list)


def _stack_to(arrays, dev):
    return torch.from_numpy(np.stack(arrays)).to(dev)


def traces_batched(eng, design_list, n_rounds: int, seeds, *,
                   round_block: int | None = None, per_node_for=()):
    """Physics traces for every seed in ``seeds``, one device pass per
    round block with the seed axis batched.  Returns one ``{design:
    StepTrace}`` dict per seed, each equal (within the tolerance
    contract) to the numpy engine's ``traces(..., legacy_streams=False,
    per_node_for=per_node_for)`` for that seed.  With a recorder on the
    engine (one seed only) the pass also fills it.  Sets ``eng.timing``
    to the wall-time split between the host draw pass and the device
    core (which includes the copies to and from the card), and the bytes
    copied back for the per-node arrays and the recorder."""
    p = eng.p
    design_list = _check_designs(eng, design_list)
    per_node_for = tuple(d for d in design_list if d in per_node_for)
    seeds = [int(s) for s in seeds]
    S = len(seeds)
    if S == 0:
        return []
    rec = eng.recorder
    if rec is not None and S != 1:
        raise ValueError("a TraceRecorder records one seed's pass: call "
                         "traces() per seed")

    ctx = _Plan(eng)
    n, steps = ctx.n, ctx.steps
    T = n_rounds * steps
    if round_block is None:
        # the numpy default, and not negotiable: the host pass must
        # consume the PFC/transfer streams in the numpy engine's exact
        # block partition or the draws land on different cells
        round_block = max(1, engine_mod._BLOCK_ELEMENTS // (steps * n))
    block_steps = round_block * steps
    dev = eng.device

    streams = [_SeedStreams(eng, s, design_list, ctx.incast) for s in seeds]
    outs = [eng._new_traces(design_list, T, ctx.plan, ctx.hgs, per_node_for)
            for _ in seeds]
    if rec is not None:
        rec.begin(design_list, plan=ctx.plan, n_rounds=n_rounds, steps=steps)
    fault_flows = ([np.zeros(T) for _ in seeds] if p.fault.active
                   else None)
    state = DcqcnState.init((S, n), device=dev)
    rate_scale = None
    fmodel = streams[0].fmodel
    if fmodel is not None and fmodel.rate_scale is not None:
        rate_scale = _stack_to([st.fmodel.rate_scale for st in streams], dev)
    host_s = device_s = 0.0
    n_blocks = 0
    copied = {"node_bytes": 0, "record_bytes": 0}
    for t0 in range(0, T, block_steps):
        tb = min(block_steps, T - t0)   # whole rounds: steps | tb
        c0 = time.perf_counter()
        host = [_host_block(eng, st, ctx, t0, tb, design_list)
                for st in streams]
        c1 = time.perf_counter()
        inp = {"cnp": _stack_to([h["cnp"] for h in host], dev),
               "phases": []}
        if rate_scale is not None:
            inp["rate_scale"] = rate_scale
        for k, h0 in enumerate(host[0]["phases"]):
            hs = [h["phases"][k] for h in host]
            ph_in = {key: _stack_to([h[key] for h in hs], dev)
                     for key in h0 if key not in designs.DESIGNS}
            for d in design_list:
                ph_in[d] = {f: _stack_to([h[d][f] for h in hs], dev)
                            for f in h0[d]}
            inp["phases"].append(ph_in)
        if fault_flows is not None:
            for si, h in enumerate(host):
                fault_flows[si][t0:t0 + tb] = h["fault_flows"]
        if rec is not None:
            for rows, counters in host[0]["counters"]:
                rec.record_fabric(t0 + rows, counters, T)
        del host
        res, state = _core(eng, ctx, inp, state, design_list, tb,
                           per_node_for)
        res = _to_host(res, copied)
        for si in range(S):
            _scatter_block(outs[si], res, si, ctx, t0, tb)
        if rec is not None:
            for k, sph in enumerate(ctx.phases):
                for d in design_list:
                    rec.record_phase(d, t0 + ctx.rows(k, tb), sph["ph"],
                                     sph["hg"], sph["n_pkts"],
                                     {f: v[0] for f, v in
                                      res[k][d]["rec"].items()})
        host_s += c1 - c0
        device_s += time.perf_counter() - c1
        n_blocks += 1
    if fault_flows is not None:
        for si in range(S):
            for tr in outs[si].values():
                tr.fault_flows = fault_flows[si]
    eng.timing = {"host_s": host_s, "device_s": device_s,
                  "blocks": n_blocks, "seeds": S, "steps": T, "nodes": n,
                  **copied}
    return outs


def _to_host(res, copied: dict):
    """Copy one block's core outputs back (numpy), counting the bytes of
    the per-node arrays and of the recorder's reductions in ``copied``."""
    out = []
    for ph in res:
        host = {}
        for d, o in ph.items():
            h = {}
            for f, v in o.items():
                if f == "rec":
                    h[f] = {g: w.cpu().numpy() for g, w in v.items()}
                    copied["record_bytes"] += sum(w.nbytes
                                                  for w in h[f].values())
                elif v is not None:
                    h[f] = v.cpu().numpy()
                    if f in ("node_t", "node_d"):
                        copied["node_bytes"] += h[f].nbytes
                else:
                    h[f] = None
            host[d] = h
        out.append(host)
    return out


def _scatter_block(out, res, si, ctx: _Plan, t0: int, tb: int):
    """Write one seed's block of core outputs into its StepTraces; the
    offered totals, and the delivered packets of reliable designs on
    fault-free traces (which equal them), are schedule constants filled
    on the host.  Per-node arrays scatter by the phase's sender
    columns."""
    for k, s in enumerate(ctx.phases):
        rows = t0 + ctx.rows(k, tb)
        npk, f = s["n_pkts"], s["ph"].src.size
        for d, tr in out.items():
            o = res[k][d]
            tr.nat_us[rows] = o["nat"][si]
            if tr.node_time_us is not None:
                cells = np.ix_(rows, s["ph"].src)
                tr.node_time_us[cells] = o["node_t"][si]
                tr.node_deliv[cells] = (float(npk) if o["node_d"] is None
                                        else o["node_d"][si])
            tr.total[rows] = float(npk * f)
            tr.deliv[rows] = o["deliv"][si] if "deliv" in o else float(npk * f)
            for kt, cols in enumerate(s["tier_np"]):
                tr.tier_total[rows, kt] = float(npk * cols.size)
                tr.tier_deliv[rows, kt] = (o["tier"][si][:, kt] if "tier" in o
                                           else float(npk * cols.size))
            if s["pod_np"] is not None:
                for kp, cols in enumerate(s["pod_np"]):
                    tr.pod_total[rows, kp] = float(npk * cols.size)
                    tr.pod_deliv[rows, kp] = (
                        o["pod"][si][:, kp] if "pod" in o
                        else float(npk * cols.size))


# ----------------------------------------------------------------------
# Legacy streams: the sequential simulator's seeded streams, replayed
# ----------------------------------------------------------------------

def _legacy_host(eng, ctx: _Plan, design_list, T: int, seed: int) -> dict:
    """The numpy engine's ``_traces_legacy`` stream consumption over the
    whole trace (float64 wherever a value feeds a replay: a flipped
    comparison there would desynchronize the stream).  Returns the
    stacked CNP channels ``(C, T, n)``, their order, and per stream class
    the float32 path occupancy and the draws."""
    p = eng.p
    net, rel = p.net, p.rel
    g = eng._geometry(seed)
    ph = ctx.phases[0]["ph"]                  # the flat ring: one phase
    src, dst, n_pkts = ph.src, ph.dst, ctx.phases[0]["n_pkts"]
    n, n_tors = ctx.n, ctx.n_tors
    host = {}
    if any(d != "roce" for d in design_list):
        # the clean fabric trace, shared by the irn/srnic/celeris streams
        u = np.random.default_rng(g["fabric_seed"]).random(
            (T, network._ADVANCE_DRAWS, n_tors))
        state0 = network.FabricState(
            bursting=np.zeros(n_tors, dtype=bool),
            occupancy=np.full(n_tors, net.idle_occupancy))
        _, occ_tor, _ = network.occupancy_trace(net, u, state0)
        del u
        ecn_clean, drop_clean, _ = engine_mod._sparse_path_curves(
            net, occ_tor, src, dst)
        host["occ_clean"] = network.path_occupancy_trace(
            net, occ_tor.astype(np.float32), src, dst)
    channels, order = [], []
    if "roce" in design_list:
        occ_tor_roce, pfc_roce = network.roce_fabric_trace(
            net, g["fabric_seed"], src, dst, T)
        ecn_roce, drop_roce, hot_roce = engine_mod._sparse_path_curves(
            net, occ_tor_roce, src, dst)
        host["occ_roce"] = network.path_occupancy_trace(
            net, occ_tor_roce.astype(np.float32), src, dst)
        # engine-native stream: ECN is zero off the hot rows, so only
        # those need uniforms
        cnp_roce = np.zeros((T, n), dtype=bool)
        cnp_roce[hot_roce] = (
            np.random.default_rng([seed, engine_mod._STREAM_CNP_ROCE])
            .random((hot_roce.size, n)) < ecn_roce[hot_roce])
        channels.append(cnp_roce)
        order.append("roce")
        host["pfc"] = pfc_roce.astype(np.float32)
        host["roce"] = _design_draws(
            "roce", n_pkts, drop_roce, rel, net,
            np.random.default_rng([seed, engine_mod._STREAM_TRANSFER["roce"]]),
            (T, n))
    if "irn" in design_list or "srnic" in design_list:
        sr = replay.replay_selective_repeat(seed, n_pkts, drop_clean,
                                            ecn_clean)
        channels.append(sr.cnp)
        order.append("sr")
        host["sr"] = {"k": sr.k, "tail": sr.tail_lost, "k2": sr.k2}
    if "celeris" in design_list:
        cel = replay.replay_celeris(seed, n_pkts, drop_clean, ecn_clean)
        channels.append(cel.cnp)
        order.append("celeris")
        host["celeris"] = {"k": cel.k}
    host["cnp"] = np.stack(channels)
    host["order"] = order
    return host


def _legacy_core(eng, ctx: _Plan, host: dict, design_list, per_node_for=()):
    """One scan call over the stacked CNP channels, then each design's
    completion times in the numpy engine's float order.  Returns, per
    design, ``nat`` ``(1, T)``, for celeris the delivered sums ``deliv``
    and ``tier`` (the reliable designs deliver everything), and for the
    designs in ``per_node_for`` the per-flow times ``node_t`` ``(1, T,
    n)``."""
    net, rel, dq = eng.p.net, eng.p.rel, eng.p.dcqcn
    dev = eng.device
    s0 = ctx.phases[0]
    n_pkts = s0["n_pkts"]
    cnp = torch.from_numpy(host["cnp"]).to(dev)
    C, T, n = cnp.shape
    # rate_trace's step mask spans every channel and flow
    any_t = cnp.any(-1).any(0).expand(C, T).contiguous()
    state = DcqcnState.init((C, n), device=dev)
    rates, _ = ops.dcqcn_scan(cnp, any_t, state.rate, state.target,
                              state.alpha, state.good_stages, dq)
    chan = {c: i for i, c in enumerate(host["order"])}

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    def pkt_time_of(rate_d, avail):
        # torch.div, not ``c / eff``: the IEEE quotient numpy takes
        eff = rate_d * avail
        return torch.div(eff.new_tensor(net.pkt_time_us),
                         torch.clamp(eff, min=1e-3))

    out = {}
    if "roce" in design_list:
        occ = on_dev(host["occ_roce"])
        pkt_time = pkt_time_of(rates[chan["roce"]],
                               network.avail_bandwidth(net, occ))
        times = (n_pkts * pkt_time + network.queue_delay_us(net, occ)
                 + net.base_rtt_us / 2)
        times = times + on_dev(host["pfc"])
        ex = (on_dev(host["roce"]["A"]).double()
              + on_dev(host["roce"]["B"]).double() * pkt_time.double())
        times = times + ex.float()
        out["roce"] = {"nat": times.amax(-1)[None]}
        if "roce" in per_node_for:
            out["roce"]["node_t"] = times[None]
    if "occ_clean" in host:
        occ = on_dev(host["occ_clean"])
        qd = network.queue_delay_us(net, occ)
        avail = network.avail_bandwidth(net, occ)
    if "sr" in chan:
        pkt_time = pkt_time_of(rates[chan["sr"]], avail)
        base = n_pkts * pkt_time + qd + net.base_rtt_us / 2
        ptf = pkt_time.double()
        k, k2 = on_dev(host["sr"]["k"]), on_dev(host["sr"]["k2"])
        k64 = k.double()
        f64 = dict(dtype=torch.float64, device=dev)
        detect = torch.where(on_dev(host["sr"]["tail"]),
                             torch.tensor(rel.rto_low_us, **f64),
                             torch.tensor(rel.nack_delay_us
                                          + net.base_rtt_us, **f64))
        # the numpy engine scatters float64 excesses into a float32
        # array: the first pass, then the re-lost second round added in
        # float64 to the stored float32 value
        extra = torch.where(k > 0, (detect + k64 * ptf).float(), 0.0)
        again = rel.rto_low_us + k2.double() * ptf
        extra = torch.where(k2 > 0, (extra.double() + again).float(), extra)
        t = base + extra
        for d in ("irn", "srnic"):
            if d not in design_list:
                continue
            if d == "srnic":
                slow = (k64 * rel.host_slowpath_us).float()
                t = torch.where(k > 0, t + slow, t)
            out[d] = {"nat": t.amax(-1)[None]}
            if d in per_node_for:
                out[d]["node_t"] = t[None]
    if "celeris" in chan:
        pkt_time = pkt_time_of(rates[chan["celeris"]], avail)
        times = (n_pkts * pkt_time + designs.CELERIS_QUEUE_OVERLAP * qd
                 + net.base_rtt_us / 2)
        # integer sums, exact in float64
        k = on_dev(host["celeris"]["k"]).double()
        out["celeris"] = {
            "nat": times.amax(-1)[None],
            "deliv": (float(n_pkts * n) - k.sum(-1))[None],
            "tier": torch.stack([float(n_pkts * c.numel())
                                 - k[:, c].sum(-1) for c in s0["tier_t"]],
                                -1)[None]}
        if "celeris" in per_node_for:
            out["celeris"]["node_t"] = times[None]
    return out


def traces_legacy(eng, design_list, n_rounds: int, seed: int, *,
                  per_node_for=()):
    """The legacy-stream physics of one seed on the flat ring: equal
    (within the tolerance contract) to the numpy engine's ``traces(...,
    legacy_streams=True, per_node_for=per_node_for)``.  The caller has
    refused what has no sequential stream (``BatchedEngine
    ._check_legacy``).  Sets ``eng.timing`` as :func:`traces_batched`
    does (one block)."""
    design_list = _check_designs(eng, design_list)
    per_node_for = tuple(d for d in design_list if d in per_node_for)
    ctx = _Plan(eng)
    T = n_rounds * ctx.steps
    c0 = time.perf_counter()
    host = _legacy_host(eng, ctx, design_list, T, int(seed))
    c1 = time.perf_counter()
    res = _legacy_core(eng, ctx, host, design_list, per_node_for)
    copied = {"node_bytes": 0, "record_bytes": 0}
    res = _to_host([res], copied)
    n_pkts = ctx.phases[0]["n_pkts"]
    for d in per_node_for:
        # celeris delivers what its replayed wire draws left; the
        # reliable designs deliver everything
        res[0][d]["node_d"] = ((n_pkts - host["celeris"]["k"])[None]
                               if d == "celeris" else None)
    out = eng._new_traces(design_list, T, ctx.plan, ctx.hgs, per_node_for)
    _scatter_block(out, res, 0, ctx, 0, T)
    eng.timing = {"host_s": c1 - c0, "device_s": time.perf_counter() - c1,
                  "blocks": 1, "seeds": 1, "steps": T, "nodes": ctx.n,
                  **copied}
    return out
