"""Tables I-II and Figs. 5, 6 and 8 on the port's modules.

Each function runs one protocol of the JAX package's benchmark scripts
(``benchmarks/table1_qp_state.py``, ``table2_resources.py``,
``fig5_schedule_tail.py``, ``fig6_scale_schedule.py``,
``fig8_serving_tail.py``) on the port's engine, on the device given, and
returns its ``BENCH_sim.json`` keys rounded as the script rounds them.
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
from repro_torch.core.transport import topology
from repro_torch.models import model as M
from repro_torch.serve import serve_step, traffic

# Tables I-II
TABLE_DESIGNS = ("roce", "irn", "srnic", "celeris")

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
    schedules=("ring", "hier", "perrail"), n_rounds=60, tail_scale=0.25,
    tag="n{nn}_o{ov}",
    loss_ratio_key="{prefix}_loss_ratio_round_phase_{sched}_{tag}",
    loss_ratio_scheds=("hier", "perrail"))
FIG6_SMOKE = Fig6Tier(
    prefix="smoke_fig6", nodes=(32,), pods=2, oversubs=(8.0,),
    schedules=("hier", "perrail"), n_rounds=40, tail_scale=0.4,
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
        coding.plan(clean.k.numel(), n_rot=FIG8_N_ROT))
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
