"""Tables I-II and Figs. 2 (the per-step window), 5, 6, 8, 9 and 10 on
the port's modules.

Each function runs one protocol of the JAX package's benchmark scripts
(``benchmarks/table1_qp_state.py``, ``table2_resources.py``,
``fig2_tail_latency.py``'s step-window run, ``fig5_schedule_tail.py``,
``fig6_scale_schedule.py``, ``fig8_serving_tail.py``,
``fig9_tail_attribution.py``, ``fig10_priority_loss.py``) on the port's
engine, on the device given, and returns its ``BENCH_sim.json`` keys
rounded as the script rounds them.
``chip_smoke.py`` runs the full tiers on the card; the tests run the same
functions on the CPU, at the smoke tiers and on cut grids of the full
ones.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.core import coding, qp_state, resource_model
from repro_torch.core.transport import coupling
from repro_torch.core.transport import engine as E
from repro_torch.core.transport import params as P
from repro_torch.core.transport import schedule as schedule_mod
from repro_torch.core.transport import telemetry, topology, trace_export
from repro_torch.core.transport.simulator import CollectiveSimulator
from repro_torch.models import model as M
from repro_torch.serve import serve_step, traffic

# Tables I-II
TABLE_DESIGNS = ("roce", "irn", "srnic", "celeris")

# the Celeris budget tightening factors (benchmarks/budgets.py:26, :27
# and :36): the paper rule (RoCE median + 1 sigma) times these
TAIL_SCALE = 0.25
SMOKE_TAIL_SCALE = 0.4
FIG10_TAIL_SCALE = 0.4

# Fig. 2's beyond-paper run (fig2_tail_latency.py:16-46): the full tier's
# 128 nodes x 300 rounds, the smoke tier's 32-node fabric x 60 rounds
# (benchmarks/run.py:147-151)
FIG2_ROUNDS, FIG2_SMOKE_ROUNDS = 300, 60

# Fig. 10 (fig10_priority_loss.py:49-61): the grid, the ratio's cap and
# floor, and its smoke tier (one 2-pod oversubscription-8 cell)
FIG10_NODES, FIG10_OVERSUBS, FIG10_PODS = (128, 256, 512), (2.0, 8.0), 4
FIG10_ROUNDS, FIG10_RATIO_CAP, FIG10_EPS = 40, 100.0, 1e-6
FIG10_RATIO_BAR = 2.0     # fig10_priority_loss.py:30, "every cell"

# Fig. 9 (fig9_tail_attribution.py:56-61): the flat cell, the 2-pod NIC
# stall cell, and the tail percentiles (p90 at the smoke tier and in the
# 40-round stall cell)
FIG9_NODES, FIG9_ROUNDS, FIG9_SMOKE_ROUNDS = 128, 60, 60
FIG9_FAULT_CELL = {"n_pods": 2, "n_nodes": 32, "oversub": 4.0,
                   "stall_rate": 3e-4, "stall_steps": 40, "n_rounds": 40}
_RECOVERY = [telemetry.COMPONENTS.index(c)
             for c in telemetry.RECOVERY_COMPONENTS]

# Fig. 5 (fig5_schedule_tail.py:33-45): the grid and the hot pod, and its
# smoke tier's 32-node fabric (the one Fig. 6's smoke tier uses)
FIG5_NODES, FIG5_ROUNDS = 128, 100
FIG5_PODS, FIG5_OVERSUBS = (2, 4), (2.0, 4.0, 8.0)
FIG5_HOTPOD_BASE, FIG5_HOTPOD_HOT = 2.0, 8.0
FIG5_SMOKE_ROUNDS = 60
SMOKE_NET = {"n_nodes": 32, "burst_on_prob": 0.0008}


@dataclasses.dataclass(frozen=True)
class Fig6Tier:
    """One tier of fig6_scale_schedule.run(): the sweep's grid, its budget
    tightening (budgets.py's TAIL_SCALE or SMOKE_TAIL_SCALE), and how its
    keys are named."""
    prefix: str
    nodes: tuple
    pods: int
    oversubs: tuple
    schedules: tuple
    n_rounds: int
    tail_scale: float
    tag: str                   # a cell's key suffix, from nn, pods, ov
    loss_ratio_key: str        # from prefix, sched, tag
    loss_ratio_scheds: tuple
    smoke_net: bool = False    # the 32-node smoke fabric as the base


FIG6_WINDOWS = ("round", "phase")
FIG6 = Fig6Tier(
    prefix="fig6", nodes=(128, 512, 1024), pods=4, oversubs=(2.0, 8.0),
    schedules=("ring", "hier", "perrail"), n_rounds=60,
    tail_scale=TAIL_SCALE,
    tag="n{nn}_o{ov}",
    loss_ratio_key="{prefix}_loss_ratio_round_phase_{sched}_{tag}",
    loss_ratio_scheds=("hier", "perrail"))
FIG6_SMOKE = Fig6Tier(
    prefix="smoke_fig6", nodes=(32,), pods=2, oversubs=(8.0,),
    schedules=("hier", "perrail"), n_rounds=40,
    tail_scale=SMOKE_TAIL_SCALE,
    tag="p{pods}_o{ov}", loss_ratio_key="{prefix}_loss_ratio_round_phase",
    loss_ratio_scheds=("hier",), smoke_net=True)

# Fig. 8 (fig8_serving_tail.py:45-67): the tiers, loads, SLO and the
# recovery cell
FIG8_TP = {"n_prefill": 112, "n_decode": 16}
FIG8_LOADS, FIG8_ROUNDS = (0.5, 0.75, 0.9), 300
FIG8_SMOKE_TP = {"n_prefill": 28, "n_decode": 4}
FIG8_SMOKE_LOADS, FIG8_SMOKE_ROUNDS = (0.6, 0.9), 120
FIG8_DESIGNS, FIG8_SLO_SCALE = ("roce", "irn", "celeris"), 1.1
FIG8_N_ROT, FIG8_TAU = 64, 0.6
FIG8_PLEN, FIG8_GEN, FIG8_SIGN_SEED = 48, 8, 42
FIG8_RECOVERY_BAR = 0.9   # coded usable context, fig8_serving_tail.py:137


def smoke_params():
    return P.SimParams(net=P.NetworkParams(**SMOKE_NET))


def table_keys(qp=qp_state, rm=resource_model):
    """Tables I and II from ``qp`` (``qp_state``) and ``rm``
    (``resource_model``), the values the reference scripts print: per
    design the per-QP bytes, reliability bytes, QP capacity, BRAM, MTBF
    and ASIC area, and the density gain, BRAM cut and MTBF gain."""
    t = rm.table2()
    keys = {}
    for d in TABLE_DESIGNS:
        keys[f"table1_qp_bytes_{d}"] = qp.qp_bytes(d)
        keys[f"table1_reliability_bytes_{d}"] = qp.reliability_state_bytes(d)
        keys[f"table1_qp_capacity_{d}"] = qp.qp_capacity(d)
        keys[f"table2_bram_{d}"] = t[d]["bram"]
        keys[f"table2_mtbf_{d}"] = t[d]["mtbf_hrs"]
        keys[f"table2_asic_area_au_{d}"] = t[d]["asic_area_au"]
    keys["table1_qp_density_gain"] = round(
        qp.qp_capacity("celeris") / qp.qp_capacity("roce"), 2)
    keys["table2_bram_cut_vs_irn_pct"] = round(
        (1 - t["celeris"]["bram"] / t["irn"]["bram"]) * 100, 1)
    keys["table2_mtbf_gain"] = round(
        t["celeris"]["mtbf_hrs"] / t["roce"]["mtbf_hrs"], 2)
    return keys


def fig5_keys(device, *, pods=FIG5_PODS, oversubs=FIG5_OVERSUBS, seed=0):
    """fig5_schedule_tail.run()'s keys: ring vs hier through ``sweep`` at
    each of ``pods`` x ``oversubs`` (128 nodes x 100 rounds), and the hot
    pod through ``hier_protocol`` beside the uniform 4-pod
    oversubscription-2 hier cell of the grid.  Returns (keys, sweep
    results, the ``hier_protocol`` passes' params)."""
    assert 4 in pods and FIG5_HOTPOD_BASE in oversubs, (pods, oversubs)
    device = str(device)
    keys, sweeps = {}, []
    uniform_hier = None
    for npods in pods:
        for ov in oversubs:
            res = E.sweep(E.BatchedSimParams(
                n_nodes=(FIG5_NODES,), seeds=(seed,), n_pods=(npods,),
                schedules=("ring", "hier"), designs=("roce", "celeris"),
                n_rounds=FIG5_ROUNDS,
                base=topology.hier_params(npods, dci_oversubscription=ov)),
                device=device)
            sweeps.append(res)
            p99 = {s: res.p99_vs_schedule("celeris")[s][0]
                   for s in ("ring", "hier")}
            cel = {key[-1]: st for key, st in res.stats.items()
                   if key[0] == "celeris"}
            if npods == 4 and ov == FIG5_HOTPOD_BASE:
                uniform_hier = cel["hier"]
            tag = f"p{npods}_o{int(ov)}"
            for s in ("ring", "hier"):
                keys[f"fig5_p99_ms_{s}_{tag}"] = round(p99[s] / 1e3, 2)
                keys[f"fig5_dci_loss_{s}_{tag}"] = round(
                    cel[s].tier_loss("dci"), 4)
            keys[f"fig5_p99_ratio_{tag}"] = round(p99["ring"] / p99["hier"],
                                                  3)
    p = topology.hier_params(
        4, n_nodes=FIG5_NODES, schedule="hier",
        dci_oversubscription=(FIG5_HOTPOD_HOT,) + (FIG5_HOTPOD_BASE,) * 3)
    hot = topology.hier_protocol(p, n_rounds=FIG5_ROUNDS, seed=seed,
                                 device=device)["celeris"]
    for name, cel in (("uniform", uniform_hier), ("hotpod", hot)):
        keys[f"fig5_{name}_p99_ms"] = round(cel.p99 / 1e3, 2)
    return keys, sweeps, [p]


def smoke_fig5_keys(device, seed=0):
    """fig5_schedule_tail.run(smoke=True)'s keys: the 2-pod 32-node ring
    vs hier A/B at oversubscription 8 through ``hier_protocol``.
    Returns (keys, the passes' params)."""
    cell, protocol = {}, []
    for sched in ("ring", "hier"):
        p = topology.hier_params(2, base=smoke_params(),
                                 dci_oversubscription=8.0, schedule=sched)
        protocol.append(p)
        cell[sched] = topology.hier_protocol(
            p, n_rounds=FIG5_SMOKE_ROUNDS, seed=seed,
            device=str(device))["celeris"]
    keys = {f"smoke_fig5_p99_ms_{s}": round(cell[s].p99 / 1e3, 2)
            for s in ("ring", "hier")}
    keys["smoke_fig5_dci_loss_hier"] = round(cell["hier"].tier_loss("dci"),
                                             4)
    keys["smoke_fig5_p99_ratio"] = round(cell["ring"].p99 / cell["hier"].p99,
                                         3)
    return keys, protocol


def fig6_keys(tier, device, seed=0):
    """fig6_scale_schedule.run()'s keys (all but the wall) for ``tier``:
    one ``sweep`` per oversubscription over its schedules x {round,
    phase} x node counts, the Celeris cell's p99, loss and DCI loss, the
    ring/hier p99 ratio where the tier has the ring, and the round/phase
    loss ratios.  Returns (keys, sweep results, by oversubscription)."""
    keys, sweeps = {}, []
    base = smoke_params() if tier.smoke_net else None
    for ov in tier.oversubs:
        res = E.sweep(E.BatchedSimParams(
            n_nodes=tier.nodes, seeds=(seed,), n_pods=(tier.pods,),
            schedules=tier.schedules, windows=FIG6_WINDOWS,
            designs=("roce", "celeris"), n_rounds=tier.n_rounds,
            timeout_scale=tier.tail_scale,
            base=topology.hier_params(tier.pods, base=base,
                                      dci_oversubscription=ov)),
            device=str(device))
        sweeps.append(res)
        for nn in tier.nodes:
            tag = tier.tag.format(nn=nn, pods=tier.pods, ov=int(ov))
            cel = {}
            for sched in tier.schedules:
                for win in FIG6_WINDOWS:
                    cel[(sched, win)] = st = res.stats[
                        ("celeris", nn, 25.0, seed, tier.pods, sched, win)]
                    cell = f"{sched}_{win}_{tag}"
                    keys[f"{tier.prefix}_p99_ms_{cell}"] = round(st.p99 / 1e3,
                                                                 2)
                    keys[f"{tier.prefix}_loss_{cell}"] = round(st.mean_loss,
                                                               4)
                    keys[f"{tier.prefix}_dci_loss_{cell}"] = round(
                        st.tier_loss("dci"), 4)
            if "ring" in tier.schedules:
                keys[f"{tier.prefix}_p99_ratio_ring_hier_round_{tag}"] = round(
                    cel[("ring", "round")].p99 / cel[("hier", "round")].p99,
                    3)
            for sched in tier.loss_ratio_scheds:
                key = tier.loss_ratio_key.format(prefix=tier.prefix,
                                                 sched=sched, tag=tag)
                keys[key] = round(max(cel[(sched, "round")].mean_loss, 1e-4)
                                  / max(cel[(sched, "phase")].mean_loss, 1e-4),
                                  3)
    return keys, sweeps


def fig8_params(tp):
    """fig8's engine configuration: the serve mesh's fabric with the
    smoke burst rate, and the KV incast plan."""
    net = traffic.serve_net_params(tp)
    return (P.SimParams(net=dataclasses.replace(net, burst_on_prob=0.0008)),
            traffic.kv_flow_plan(tp))


def fig8_engine_rounds(tp, n_rounds, seed, device):
    """fig8's one engine pass over the KV incast plan (every design), the
    Celeris SLO budget (FIG8_SLO_SCALE x its natural median round) and
    each design's rounds.  Returns (stats, budget, engine)."""
    params, plan = fig8_params(tp)
    eng = E.BatchedEngine(params, plan=plan, device=str(device))
    tr = eng.traces(list(FIG8_DESIGNS), n_rounds, seed, legacy_streams=False)
    steps = tr["celeris"].steps_per_round
    nat_rounds = tr["celeris"].nat_us.reshape(-1, steps).sum(axis=1)
    budget = float(np.percentile(nat_rounds, 50)) * FIG8_SLO_SCALE
    stats = {d: (eng.assemble(tr[d], seed, celeris_timeout_us=budget,
                              adaptive=False, window="round")
                 if d == "celeris" else eng.assemble(tr[d], seed))
             for d in FIG8_DESIGNS}
    return stats, budget, eng


def fig8_keys(tp0, loads, stats, budget, seed, prefix):
    """fig8_serving_tail.run()'s engine-derived keys: the request process
    and the FIFO queue per design and load over the engine's rounds,
    rounded as it rounds them.  Returns (keys, the clipped tail delivered
    fraction of the recovery cell)."""
    keys = {f"{prefix}_slo_round_ms": round(budget / 1e3, 3),
            f"{prefix}_kv_loss_celeris": round(stats["celeris"].mean_loss,
                                               4)}
    hiload, p99, kv_frac_tail = loads[-1], {}, 1.0
    for load in loads:
        tp = dataclasses.replace(tp0, load=load)
        tag = f"{load:g}".replace(".", "p")
        for d in FIG8_DESIGNS:
            st = stats[d]
            trace = traffic.request_trace(tp, float(st.times_us.sum()),
                                          budget, seed)
            sim = traffic.simulate_serving(tp, st.times_us, st.recv_frac,
                                           trace)
            p99[(d, load)] = sim.p99_latency_us
            keys[f"{prefix}_token_p99_ms_{d}_load{tag}"] = round(
                sim.p99_latency_us / 1e3, 2)
            keys[f"{prefix}_completion_{d}_load{tag}"] = round(
                sim.completion_frac, 4)
            if d == "celeris":
                keys[f"{prefix}_kv_frac_celeris_load{tag}"] = round(
                    sim.mean_kv_frac, 4)
                if load == hiload and sim.completed.any():
                    kv_frac_tail = float(np.percentile(
                        sim.kv_frac[sim.completed], 1))
    ratio = p99[("roce", hiload)] / max(p99[("celeris", hiload)], 1e-9)
    keys[f"{prefix}_p99_ratio_roce_celeris_hiload"] = round(min(ratio,
                                                                1000.0), 2)
    keys[f"{prefix}_celeris_beats_roce_hiload"] = float(
        p99[("celeris", hiload)] < p99[("roce", hiload)])
    f_cell = float(np.clip(kv_frac_tail, 0.5, 0.95))
    keys[f"{prefix}_kv_frac_tail_celeris_hiload"] = round(f_cell, 4)
    return keys, f_cell


def fig8_recovery(device, kv_frac, seed):
    """fig8's recovery cell: the smoke LM decodes FIG8_GEN tokens from
    caches shipped at ``kv_frac`` through ``degrade_caches`` (coded: the
    FWHT and unbias kernels; uncoded: holes).  Returns the usable-context
    fractions (K/V error <= FIG8_TAU) and token agreements with the clean
    decode, by ``coded``; and the coded transfer's inputs: the clean
    caches, the wire-row mask and the rotation signs."""
    device = torch.device(device)
    cfg = C.get_smoke("qwen2-0.5b")
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, FIG8_PLEN),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    prefill = serve_step.make_prefill(cfg, FIG8_PLEN + FIG8_GEN)
    logits, clean = prefill(params, prompt)
    first = torch.argmax(logits, -1)[:, None]
    clean_toks = serve_step.greedy_decode(cfg, params, clean.clone(), first,
                                          FIG8_PLEN, FIG8_GEN)
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([kv_frac]), FIG8_N_ROT, seed=seed)[0], device=device)
    signs = coding.rademacher(
        torch.Generator(device).manual_seed(FIG8_SIGN_SEED),
        coding.plan(clean.leaves()[0].numel(), n_rot=FIG8_N_ROT))
    out = {}
    for coded in (True, False):
        caches = serve_step.degrade_caches(clean, mask, coded=coded,
                                           signs=signs if coded else None)
        err = serve_step.kv_position_error(clean, caches, FIG8_PLEN)
        toks = serve_step.greedy_decode(cfg, params, caches, first,
                                        FIG8_PLEN, FIG8_GEN)
        out["coded" if coded else "uncoded"] = {
            "usable": (err <= FIG8_TAU).float().mean().item(),
            "token_agree": (toks == clean_toks).float().mean().item()}
    out["wire_rows_lost"] = int(FIG8_N_ROT - mask.sum().item())
    return out, (clean, mask, signs)


# ----------------------------------------------------------------------
# Fig. 2's per-step window
# ----------------------------------------------------------------------

def fig2_step_window(device, roce_p99, *, params=None, n_rounds=FIG2_ROUNDS,
                     seed=0, prefix="fig2"):
    """fig2_tail_latency.run()'s beyond-paper key: the adaptive per-step
    window (``CollectiveSimulator.run("celeris", adaptive=True,
    window="step")``, the shared-fabric mode with Celeris's per-flow
    arrays) against ``roce_p99``, the same run's legacy-stream RoCE p99.
    Returns (keys, the Celeris stats, the engine's timing)."""
    sim = CollectiveSimulator(params or P.SimParams(), device=str(device))
    st = sim.run("celeris", n_rounds, adaptive=True, window="step",
                 seed=seed)
    keys = {f"{prefix}_beyond_step_window_reduction": round(
        roce_p99 / st.p99, 2)}
    return keys, st, dict(sim._engine.timing)


# ----------------------------------------------------------------------
# Fig. 10: priority-ordered against arrival-ordered window cuts
# ----------------------------------------------------------------------

def paper_budget(base, tail_scale):
    """The Celeris budget: the paper rule (RoCE's median + 1 sigma round
    time, from ``base``'s stats) times ``tail_scale``."""
    return float((np.percentile(base.times_us, 50) + base.times_us.std())
                 * tail_scale)


def fig10_traces(params, n_rounds, seed, device):
    """One fabric cell's traces for Fig. 10: the engine, the Celeris trace
    with the layer-depth priority classes (``schedule.layer_priorities``)
    and RoCE's stats, which set the budget."""
    plan = schedule_mod.make_plan(params.net, params.topo, params.work)
    cls = schedule_mod.layer_priorities(plan)
    eng = E.BatchedEngine(params, device=str(device))
    tr = eng.traces(["roce", "celeris"], n_rounds, seed,
                    legacy_streams=False)
    cel = dataclasses.replace(tr["celeris"], step_priority=cls)
    return eng, cel, eng.assemble(tr["roce"], seed)


def fig10_cut(eng, cel, seed, budget_us, order, window="round"):
    """The Celeris trace assembled at a fixed budget under one cut order."""
    return eng.assemble(cel, seed, celeris_timeout_us=budget_us,
                        adaptive=False, window=window, cut_order=order)


def fig10_cell(params, n_rounds, seed, timeout_scale, device):
    """One fabric cell assembled under both cut orders: the same trace and
    budget, so the two stats share their round times and differ only in
    where the cut lands.  Returns (p99 in ms, {order: RoundStats}, the
    engine's timing)."""
    eng, cel, base = fig10_traces(params, n_rounds, seed, device)
    to = paper_budget(base, timeout_scale)
    stats = {order: fig10_cut(eng, cel, seed, to, order)
             for order in ("arrival", "priority")}
    assert np.array_equal(stats["arrival"].times_us,
                          stats["priority"].times_us), \
        "cut orders must share round times (matched p99 by construction)"
    return float(stats["arrival"].p99) / 1e3, stats, dict(eng.timing)


def fig10_emit(keys, prefix, tag, p99_ms, stats):
    """One cell's keys: p99, the top and bottom classes' loss under each
    order, and arrival's top-class loss over priority's (capped)."""
    top = np.asarray(stats["arrival"].prio_pkts).size - 1
    keys[f"{prefix}_p99_ms_{tag}"] = round(p99_ms, 2)
    for order in ("arrival", "priority"):
        st = stats[order]
        keys[f"{prefix}_hi_loss_{order}_{tag}"] = round(st.prio_loss(top), 4)
        keys[f"{prefix}_lo_loss_{order}_{tag}"] = round(st.prio_loss(0), 4)
    ratio = min(stats["arrival"].prio_loss(top)
                / max(stats["priority"].prio_loss(top), FIG10_EPS),
                FIG10_RATIO_CAP)
    keys[f"{prefix}_hi_loss_ratio_{tag}"] = round(ratio, 3)
    return ratio


def fig10_keys(device, *, nodes=FIG10_NODES, oversubs=FIG10_OVERSUBS,
               n_rounds=FIG10_ROUNDS, seed=0):
    """fig10_priority_loss.run()'s keys (all but the wall): the hier
    schedule on 4 pods at each of ``nodes`` x ``oversubs``, round window
    at the paper rule x FIG10_TAIL_SCALE.  Returns (keys, {tag: (stats,
    timing)})."""
    keys, cells = {}, {}
    for ov in oversubs:
        for nn in nodes:
            tag = f"n{nn}_o{int(ov)}"
            p = topology.hier_params(FIG10_PODS, n_nodes=nn,
                                     dci_oversubscription=ov,
                                     schedule="hier")
            p99_ms, stats, timing = fig10_cell(p, n_rounds, seed,
                                               FIG10_TAIL_SCALE, device)
            fig10_emit(keys, "fig10", tag, p99_ms, stats)
            cells[tag] = (stats, timing)
    return keys, cells


def smoke_fig10_keys(device, seed=0):
    """fig10_priority_loss.run(smoke=True)'s keys: the 2-pod 32-node hier
    cell at oversubscription 8 and the smoke budget.  Returns (keys,
    {order: RoundStats})."""
    p = topology.hier_params(2, base=smoke_params(),
                             dci_oversubscription=8.0, schedule="hier")
    p99_ms, stats, _ = fig10_cell(p, 40, seed, SMOKE_TAIL_SCALE, device)
    keys = {}
    fig10_emit(keys, "smoke_fig10", "p2_o8", p99_ms, stats)
    return keys, stats


# ----------------------------------------------------------------------
# Fig. 9: tail attribution through the flight recorder
# ----------------------------------------------------------------------

def fig9_recorded_pair(params, n_rounds, seed, tail_scale, device,
                       record=True):
    """One engine pass, RoCE and Celeris (the adaptive window from the
    paper rule x ``tail_scale``), recorded unless ``record`` is False.
    Returns ({design: (stats, record or None)}, the recorder or None, the
    engine's timing)."""
    rec = telemetry.TraceRecorder() if record else None
    eng = E.BatchedEngine(params, recorder=rec, device=str(device))
    tr = eng.traces(["roce", "celeris"], n_rounds, seed,
                    legacy_streams=False)
    base = eng.assemble(tr["roce"], seed)
    cel = eng.assemble(tr["celeris"], seed,
                       celeris_timeout_us=paper_budget(base, tail_scale))
    cells = {"roce": base, "celeris": cel}
    return ({d: (st, None if rec is None else rec.record(d))
             for d, st in cells.items()}, rec, dict(eng.timing))


def fig9_tail_excess(record, q):
    """Per-component tail excess: the mean round at or above the q-th
    natural-time percentile minus the median round, floored at zero."""
    comp = record.round_components()
    tail = record.tail_rounds(q)
    ex = np.maximum(comp[tail].mean(axis=0) - np.median(comp, axis=0), 0.0)
    return ex, float(max(ex.sum(), 1e-12))


def fig9_cell_keys(cells, q, prefix, tag, keys):
    """One {design: (stats, record)} cell's keys, each pair audited
    (``telemetry.audit_round`` raises on a conservation failure).
    Returns ({design: recovery share of the tail excess}, {design: the
    audit's summary})."""
    sfx = f"_{tag}" if tag else ""
    shares, audits = {}, {}
    for d, (st, r) in cells.items():
        audits[d] = telemetry.audit_round(st, r)
        ex, tot = fig9_tail_excess(r, q)
        shares[d] = float(ex[_RECOVERY].sum() / tot)
        for i, c in enumerate(telemetry.COMPONENTS):
            v = float(ex[i] / tot)
            if v > 5e-4 or c in telemetry.RECOVERY_COMPONENTS:
                keys[f"{prefix}_tailex_{c}_{d}{sfx}"] = round(v, 4)
        keys[f"{prefix}_p99_ms_{d}{sfx}"] = round(
            float(np.percentile(st.times_us, 99)) / 1e3, 2)
    keys[f"{prefix}_recovery_share_tailex_roce{sfx}"] = round(
        shares["roce"], 4)
    keys[f"{prefix}_celeris_tailex_datapath_share{sfx}"] = round(
        1.0 - shares["celeris"], 4)
    keys[f"{prefix}_roce_recovery_gt_celeris{sfx}"] = float(
        shares["roce"] > shares["celeris"] + 0.01)
    lr = cells["celeris"][1].loss_rates().mean(axis=0)
    for i, c in enumerate(telemetry.CAUSES):
        keys[f"{prefix}_loss_{c}_celeris{sfx}"] = round(float(lr[i]), 4)
    return shares, audits


def fig9_fault_params():
    """Fig. 9's 2-pod hier cell with NIC stalls (FIG9_FAULT_CELL)."""
    fc = FIG9_FAULT_CELL
    return topology.hier_params(
        fc["n_pods"], base=P.SimParams(net=P.NetworkParams(
            n_nodes=fc["n_nodes"], burst_on_prob=0.0008)),
        dci_oversubscription=fc["oversub"],
        fault=P.FaultParams(stall_rate=fc["stall_rate"],
                            stall_steps=fc["stall_steps"]))


def fig9_fault_cell(device, seed, record=True):
    """Fig. 9's stall cell through ``hier_protocol(recorder=)``, recorded
    unless ``record`` is False.  Returns ({design: (stats, record or
    None)}, the recorder or None, the protocol's params)."""
    hp = fig9_fault_params()
    rec = telemetry.TraceRecorder() if record else None
    stats = topology.hier_protocol(hp, FIG9_FAULT_CELL["n_rounds"], seed,
                                   timeout_scale=TAIL_SCALE, recorder=rec,
                                   device=str(device))
    return ({d: (stats[d], None if rec is None else rec.record(d))
             for d in ("roce", "celeris")}, rec, hp)


def fig9_keys(device, seed=0, trace_path=None):
    """fig9_tail_attribution.run()'s keys (all but the wall): the
    128-node flat ring (p99 tail) and the 2-pod stall cell (seed + 1, p90
    tail), every recorded pair audited, the fault component visible in
    RoCE's tail and the fault cause in Celeris's loss; with
    ``trace_path``, the stall cell's Perfetto trace written there
    (``trace_export.write_trace``, each chunk validated).  Returns (keys,
    info: the audits, both cells' stats and records, the flat cell's
    timing, both cells' params, the trace's event counts)."""
    keys = {}
    p = P.SimParams(net=P.NetworkParams(n_nodes=FIG9_NODES))
    cells, _, timing = fig9_recorded_pair(p, FIG9_ROUNDS, seed, TAIL_SCALE,
                                          device)
    _, audits = fig9_cell_keys(cells, 99.0, "fig9", "", keys)
    fcells, rec, fault_params = fig9_fault_cell(device, seed + 1)
    _, f_audits = fig9_cell_keys(fcells, 90.0, "fig9", "fault", keys)
    rr = fcells["roce"][1].round_components()
    fshare = float(rr[:, telemetry.COMPONENTS.index("fault")].sum()
                   / max(rr.sum(), 1e-12))
    keys["fig9_fault_visible_roce"] = float(fshare > 0.0)
    keys["fig9_fault_loss_visible_celeris"] = float(
        fcells["celeris"][1].loss_rates()[
            :, telemetry.CAUSES.index("fault")].sum() > 0.0)
    counts = None
    if trace_path is not None:
        counts = trace_export.write_trace(rec, trace_path,
                                          meta={"figure": "fig9",
                                                "cell": "fault"})
    keys["fig9_audit_pass"] = 1.0
    info = {"audits": {"flat": audits, "fault": f_audits},
            "cells": cells, "fault_cells": fcells, "timing": timing,
            "flat_params": p, "fault_params": fault_params,
            "provenance": telemetry.provenance_from_record(
                fcells["celeris"][1], "cross").describe(),
            "trace_counts": counts}
    return keys, info


def smoke_fig9_keys(device, seed=0):
    """fig9_tail_attribution.run(smoke=True)'s keys: the 32-node smoke
    fabric, flat ring, 60 rounds, p90 tail.  Returns (keys, {design:
    (stats, record)})."""
    cells, _, _ = fig9_recorded_pair(smoke_params(), FIG9_SMOKE_ROUNDS, seed,
                                     SMOKE_TAIL_SCALE, device)
    keys = {}
    fig9_cell_keys(cells, 90.0, "smoke_fig9", "", keys)
    keys["smoke_fig9_audit_pass"] = 1.0
    return keys, cells
