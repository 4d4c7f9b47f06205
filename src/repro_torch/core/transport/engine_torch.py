"""The engine's device backend in torch (port of
``repro/core/transport/engine_jax.py``, the shared-fabric flat ring).

The numpy engine (``repro.core.transport.engine``) is the reference:
every seeded statistic is defined by its exact draw order.  This module
keeps that order and moves the rate-dependent physics to the card.

Hybrid split (the replay contract decides what goes where)
----------------------------------------------------------
Everything that *consumes a random substream* stays on the host in
numpy, block for block in the numpy engine's exact order: the burst
chains, the hot-row ECN/drop curves that gate CNP and loss draws, the
PFC cascade, and the per-design loss draws (the shared helpers in
:mod:`designs`).  Loss draws depend only on the drop curve, never on
the DCQCN rate, so each design's recovery machinery reduces to dense
rate-independent fields::

    excess_time = A + B * pkt_time        (reliable designs)
    delivered   = n_pkts - wire_losses    (celeris)

Everything *rate-dependent* runs as torch ops on the engine's device,
with the seed axis written out as the leading dimension: the DCQCN
recurrence (one launch of the hand-written scan kernel per block,
``kernels/csrc/dcqcn.cu``; its plain version on the CPU), the
queue/bandwidth response curves (one formula source: :mod:`network`),
per-design completion times and the per-step reductions.  The float
types follow the numpy engine: float32 times, float64 where it casts
(the excess ``A + B * pkt_time``).

Tolerance contract
------------------
The host pass replays the numpy engine's streams exactly, so both see
the same draws and delivered packets agree exactly.  The core regroups
a few float accumulations (the A/B split above, ``occ ** 3`` as two
multiplies, the ``pow`` of the alpha decay), leaving relative
differences near 1e-7 on step times: the contract is rtol 1e-5 on
times, p99 and delivered fractions, as for ``engine_jax``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.transport import designs, network
from repro_torch.core.transport import engine as engine_mod
from repro_torch.core.transport.dcqcn import DcqcnState
from repro_torch.kernels import ops


class _SeedStreams:
    """One seed's generators and carried chain state, consumed block by
    block in the numpy engine's exact order (the replay contract)."""

    def __init__(self, eng, seed: int, design_list):
        g = eng._geometry(seed)
        net = eng.p.net
        n_tors = g["n_tors"]
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


def _host_block(eng, st: _SeedStreams, tb: int, design_list, src, dst,
                n_pkts):
    """One seed's draw pass for the next ``tb`` steps: exactly the numpy
    engine's stream consumption on the flat ring, minus the
    rate-dependent math the core does."""
    net, rel = eng.p.net, eng.p.rel
    n_tors = net.n_nodes // net.nodes_per_tor
    u = st.fabric_gen.random((tb, network._ADVANCE_DRAWS, n_tors))
    _, occ_tor, st.fab_state = network.occupancy_trace(net, u, st.fab_state)
    ecn_p, drop_p, hot = engine_mod._sparse_path_curves(net, occ_tor, src,
                                                        dst)
    occ32 = network.path_occupancy_trace(net, occ_tor.astype(np.float32),
                                         src, dst)
    cnp = np.zeros((tb, src.size), dtype=bool)
    cnp[hot] = st.cnp_gen.random((hot.size, src.size)) < ecn_p[hot]
    host = {"cnp": cnp, "occ32": occ32}
    # PFC + loss draws, design by design (the PFC stream is consumed on
    # the roce iteration only); its pauses are multiples of
    # pfc_pause_us, exact in float32
    for d in design_list:
        if d == "roce":
            host["pfc"] = network.pfc_pause_trace(
                net, occ32, st.pfc_gen).astype(np.float32)
        host[d] = _design_draws(d, n_pkts, drop_p, rel, net,
                                st.transfer_gens[d], occ32.shape)
    return host


def _core(eng, inp, state: DcqcnState, design_list, n_pkts, tier_cols):
    """The rate-dependent physics of one block, all seeds at once.

    ``inp`` holds ``(S, tb, n)`` tensors on the engine's device.  Returns
    per design the per-step max completion time ``nat`` ``(S, tb)``
    and, for celeris, the delivered sums ``deliv`` ``(S, tb)`` and
    ``tier`` ``(S, tb, n_tiers)``; and the carried DCQCN state.
    """
    net, dq = eng.p.net, eng.p.dcqcn
    cnp = inp["cnp"]
    rates, (r, t, a, g) = ops.dcqcn_scan(
        cnp, cnp.any(-1), state.rate, state.target, state.alpha,
        state.good_stages, dq)
    occ32 = inp["occ32"]
    qd = network.queue_delay_us(net, occ32)
    eff = rates * network.avail_bandwidth(net, occ32)
    # torch.div, not ``c / eff``: the reflected operator multiplies by
    # the reciprocal, which is not the IEEE quotient numpy takes
    pkt_time = torch.div(eff.new_tensor(net.pkt_time_us),
                         torch.clamp(eff, min=1e-3))
    ptf64 = pkt_time.double()
    serialize = n_pkts * pkt_time
    out = {}
    for d in design_list:
        if d == "celeris":
            times = (serialize + designs.CELERIS_QUEUE_OVERLAP * qd
                     + net.base_rtt_us / 2)
            deliv = inp[d]["deliv"]
            out[d] = {"nat": times.amax(-1), "deliv": deliv.sum(-1),
                      "tier": torch.stack([deliv[..., c].sum(-1)
                                           for c in tier_cols], -1)}
            continue
        times = serialize + qd + net.base_rtt_us / 2
        if d == "roce":
            times = times + inp["pfc"]
        ex = inp[d]["A"].double() + inp[d]["B"].double() * ptf64
        out[d] = {"nat": (times + ex.float()).amax(-1)}
    return out, DcqcnState(rate=r, target=t, alpha=a, good_stages=g)


def _stack_to(host, key, dev, design=None):
    arrays = [h[key] if design is None else h[design][key] for h in host]
    return torch.from_numpy(np.stack(arrays)).to(dev)


def traces_batched(eng, design_list, n_rounds: int, seeds, *,
                   round_block: int | None = None):
    """Physics traces for every seed in ``seeds``, one device pass per
    round block with the seed axis batched.  Returns one ``{design:
    StepTrace}`` dict per seed, each equal (within the tolerance
    contract) to the numpy engine's ``traces(..., legacy_streams=False)``
    for that seed.  Sets ``eng.timing`` to the wall-time split between
    the host draw pass and the device core (which includes the copies
    to and from the card)."""
    p = eng.p
    net = p.net
    unknown = [d for d in design_list if d not in designs.DESIGNS]
    if unknown:
        raise ValueError(f"unknown design(s) {unknown}; "
                         f"choose from {designs.DESIGNS}")
    if net.n_nodes < net.nodes_per_tor or net.n_nodes % net.nodes_per_tor:
        raise ValueError(
            f"n_nodes={net.n_nodes} must be a positive multiple of "
            f"nodes_per_tor={net.nodes_per_tor}")
    if net.ecn_threshold > net.loss_knee:
        raise ValueError(
            f"ecn_threshold={net.ecn_threshold} must not exceed "
            f"loss_knee={net.loss_knee}")
    design_list = list(design_list)
    seeds = [int(s) for s in seeds]
    S = len(seeds)
    if S == 0:
        return []

    g0 = eng._geometry(seeds[0])
    n, steps, plan = g0["n"], g0["steps"], g0["plan"]
    T = n_rounds * steps
    if round_block is None:
        # the numpy default, and not negotiable: the host pass must
        # consume the PFC/transfer streams in the numpy engine's exact
        # block partition or the draws land on different cells
        round_block = max(1, engine_mod._BLOCK_ELEMENTS // (steps * n))
    block_steps = round_block * steps
    ph = plan.phases[0]
    src, dst = ph.src, ph.dst
    n_pkts = ph.n_pkts(net)
    hgs = plan.geometries(net, p.topo)
    tier_np = hgs[0].tier_cols
    dev = eng.device
    tier_cols = [torch.as_tensor(c, dtype=torch.long, device=dev)
                 for c in tier_np]

    streams = [_SeedStreams(eng, s, design_list) for s in seeds]
    outs = [eng._new_traces(design_list, T, steps, plan, hgs) for _ in seeds]
    state = DcqcnState.init((S, n), device=dev)
    host_s = device_s = 0.0
    n_blocks = 0
    for t0 in range(0, T, block_steps):
        tb = min(block_steps, T - t0)   # whole rounds: steps | tb
        c0 = time.perf_counter()
        host = [_host_block(eng, st, tb, design_list, src, dst, n_pkts)
                for st in streams]
        c1 = time.perf_counter()
        inp = {k: _stack_to(host, k, dev) for k in ("cnp", "occ32")}
        if "roce" in design_list:
            inp["pfc"] = _stack_to(host, "pfc", dev)
        for d in design_list:
            inp[d] = {k: _stack_to(host, k, dev, d) for k in host[0][d]}
        del host
        res, state = _core(eng, inp, state, design_list, n_pkts, tier_cols)
        res = {d: {k: v.cpu().numpy() for k, v in o.items()}
               for d, o in res.items()}
        rows = slice(t0, t0 + tb)
        for si in range(S):
            _scatter_block(outs[si], res, si, rows, n_pkts, n, tier_np)
        host_s += c1 - c0
        device_s += time.perf_counter() - c1
        n_blocks += 1
    eng.timing = {"host_s": host_s, "device_s": device_s,
                  "blocks": n_blocks, "seeds": S, "steps": T, "nodes": n}
    return outs


def _scatter_block(out, res, si, rows, n_pkts, n, tier_cols):
    """Write one seed's block of core outputs into its StepTraces; the
    offered totals (and the reliable designs' delivered packets, which
    equal them) are schedule constants filled on the host."""
    for d, tr in out.items():
        o = res[d]
        tr.nat_us[rows] = o["nat"][si]
        tr.total[rows] = float(n_pkts * n)
        tr.deliv[rows] = o["deliv"][si] if "deliv" in o else float(n_pkts * n)
        for kt, cols in enumerate(tier_cols):
            tr.tier_total[rows, kt] = float(n_pkts * cols.size)
            tr.tier_deliv[rows, kt] = (o["tier"][si][:, kt] if "tier" in o
                                       else float(n_pkts * cols.size))
