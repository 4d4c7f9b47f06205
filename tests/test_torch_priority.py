"""The port's priority cut and per-step window against the numpy engine
of the JAX package, on the CPU (``tests/test_schedule.py``'s priority and
step-window tests, ``tests/test_timeout_and_transport.py``'s adaptive
step window, and the Fig.-10 and Fig.-2 step-window keys).

Both engines draw the same host streams in the same stream mode, so
delivered packets are exact; times, p99 and delivered fractions are held
to rtol 1e-5 (the engine's tolerance contract, see
``tests/test_torch_engine.py``).  The priority cut is host numpy over the
reduced traces, so its reallocation is the reference's own arithmetic.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmarks import fig10_priority_loss as jfig10
from repro.core.transport import coupling as jcoupling
from repro.core.transport import engine as jengine
from repro.core.transport import params as jparams
from repro.core.transport import schedule as jschedule
from repro.core.transport import topology as jtopology
from repro.core.transport.simulator import CollectiveSimulator as JSim
from repro_torch.benchmarks import figs
from repro_torch.core.transport import coupling as tcoupling
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport import schedule as tschedule
from repro_torch.core.transport import topology as ttopology
from repro_torch.core.transport.simulator import CollectiveSimulator as TSim

RTOL = 1e-5
DATA = os.path.join(os.path.dirname(__file__), "data")
BENCH = os.path.join(os.path.dirname(DATA), "..", "BENCH_sim.json")
GROUPS = ("times_us", "recv_frac", "tier_recv_frac", "pod_recv_frac",
          "prio_recv_frac")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(mod, **net):
    """tests/test_schedule.py's SMALL fabric from ``mod``'s params."""
    return mod.SimParams(net=mod.NetworkParams(
        n_nodes=32, burst_on_prob=0.0008, **net))


def _engines(params_of, **kw):
    """(numpy engine, port engine on the CPU) over ``params_of(mod)``."""
    return (jengine.BatchedEngine(params_of(jparams), **kw),
            tengine.BatchedEngine(params_of(tparams), device="cpu", **kw))


def _hier(npods, schedule="hier", ov=8.0, **net):
    def params_of(mod):
        topo = jtopology if mod is jparams else ttopology
        return topo.hier_params(npods, base=_small(mod, **net),
                                dci_oversubscription=ov, schedule=schedule)
    return params_of


def _close_stats(got, want, what=""):
    for f in GROUPS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, (what, f)
            continue
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                   err_msg=f"{what} {f}")
    assert np.isclose(got.p99, want.p99, rtol=RTOL, atol=0), what
    for f in ("prio_pkts", "tier_pkts", "pod_pkts"):
        a, b = getattr(got, f), getattr(want, f)
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


def _committed(key):
    with open(BENCH) as f:
        return json.load(f)[key]


# ------------------------------------------------ per-flow (T, n) traces

@pytest.mark.parametrize("legacy", [False, True], ids=["shared", "legacy"])
def test_per_node_traces_match_numpy(legacy):
    """Every design's per-flow times and delivered packets, in both
    stream modes: packets exact, times rtol 1e-5."""
    jeng, teng = _engines(_small)
    designs = list(jengine.designs.DESIGNS)
    want = jeng.traces(designs, 6, 3, legacy_streams=legacy,
                       per_node_for=designs)
    got = teng.traces(designs, 6, 3, legacy_streams=legacy,
                      per_node_for=designs)
    for d in designs:
        np.testing.assert_array_equal(got[d].node_deliv, want[d].node_deliv)
        np.testing.assert_allclose(got[d].node_time_us, want[d].node_time_us,
                                   rtol=RTOL, atol=0, err_msg=d)
    assert teng.timing["node_bytes"] > 0


def test_per_node_traces_multi_phase_and_faults():
    """The hier plan's phases scatter by sender column (idle cells stay
    zero) and the fault reactions reach the per-flow arrays."""
    def params_of(mod):
        topo = jtopology if mod is jparams else ttopology
        return topo.hier_params(2, base=_small(mod), schedule="hier",
                                fault=mod.FaultParams(stall_rate=3e-4,
                                                      stall_steps=40))
    jeng, teng = _engines(params_of)
    want = jeng.traces(["roce", "celeris"], 5, 1, legacy_streams=False,
                       per_node_for=("roce", "celeris"))
    got = teng.traces(["roce", "celeris"], 5, 1, legacy_streams=False,
                      per_node_for=("roce", "celeris"))
    for d in ("roce", "celeris"):
        np.testing.assert_array_equal(got[d].node_deliv, want[d].node_deliv)
        np.testing.assert_allclose(got[d].node_time_us, want[d].node_time_us,
                                   rtol=RTOL, atol=0)
        assert (want[d].node_time_us == 0).any()       # idle cells
    assert want["roce"].fault_flows.sum() > 0


def test_no_per_node_copy_unless_asked():
    _, teng = _engines(_small)
    tr = teng.traces(["roce", "celeris"], 3, 0, legacy_streams=False)
    assert tr["celeris"].node_time_us is None
    assert teng.timing["node_bytes"] == 0 == teng.timing["record_bytes"]


# -------------------------------------------------------- step window

@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
@pytest.mark.parametrize("legacy", [False, True], ids=["shared", "legacy"])
def test_step_window_matches_numpy(legacy, adaptive):
    """``run(window="step")`` with a binding budget: adaptive Celeris
    flips to the shared fabric, a fixed window honours legacy streams."""
    jeng, teng = _engines(_small)
    kw = dict(window="step", adaptive=adaptive, legacy_streams=legacy,
              seed=2, celeris_timeout_us=3_000.0)
    want = jeng.run("celeris", 12, **kw)
    got = teng.run("celeris", 12, **kw)
    assert want.recv_frac.min() < 1.0           # the window binds
    _close_stats(got, want, f"legacy={legacy} adaptive={adaptive}")


def test_step_window_runs_on_multi_phase_plan():
    """tests/test_schedule.py:251: the step window divides each phase's
    budget share over its steps on the hier plan, and still demands
    per-flow data."""
    jeng, teng = _engines(_hier(2, ov=4.0))
    kw = dict(window="step", adaptive=False, legacy_streams=False,
              celeris_timeout_us=50_000.0)
    want = jeng.run("celeris", 10, **kw)
    st = teng.run("celeris", 10, **kw)
    assert st.times_us.shape == (10,)
    assert np.all(st.times_us <= 50_000.0 + 1e-6)
    assert np.all((st.recv_frac >= 0) & (st.recv_frac <= 1))
    assert st.tier_recv_frac.shape == (10, 3)
    assert st.pod_recv_frac.shape == (10, 2)
    _close_stats(st, want, "hier step")
    tr = teng.traces(["celeris"], 5, 0, legacy_streams=False)
    with pytest.raises(ValueError, match="per-flow"):
        teng.assemble(tr["celeris"], 0, window="step", adaptive=False)


def test_step_window_tight_budget_on_hier_plan():
    """A budget that binds on the multi-phase plan: the per-tier, per-pod
    and per-class scatter of the per-flow cut against the numpy
    engine's."""
    jeng, teng = _engines(_hier(2))
    kw = dict(window="step", legacy_streams=False, seed=4,
              celeris_timeout_us=4_000.0)
    want = jeng.run("celeris", 8, **kw)
    got = teng.run("celeris", 8, **kw)
    assert want.tier_loss("dci") > 0.0
    _close_stats(got, want, "hier tight step")


def test_step_window_guards():
    """The numpy engine's refusals: no per-phase sender map on a
    multi-phase plan, no flow→tier map."""
    jeng, teng = _engines(_hier(2))
    for eng in (jeng, teng):
        tr = eng.traces(["celeris"], 2, 0, legacy_streams=False,
                        per_node_for=("celeris",))["celeris"]
        with pytest.raises(ValueError, match="sender maps"):
            eng.assemble(dataclasses.replace(tr, phase_src=None), 0,
                         window="step", adaptive=False)
        with pytest.raises(ValueError, match="flow→tier"):
            eng.assemble(dataclasses.replace(tr, phase_tier_cols=None), 0,
                         window="step", adaptive=False)


def test_celeris_step_window_flattens_tail():
    """tests/test_timeout_and_transport.py:94 on the port: the adaptive
    step window flattens the tail below RoCE's at < 1 % loss, and both
    agree with the numpy engine's simulator."""
    tsim = TSim(_small(tparams), device="cpu")
    jsim = JSim(_small(jparams))
    base = tsim.run("roce", 120, seed=2)
    cel = tsim.run("celeris", 120, adaptive=True, window="step", seed=2)
    assert cel.p99 / cel.p50 < base.p99 / base.p50
    assert cel.mean_loss < 0.01
    _close_stats(cel, jsim.run("celeris", 120, adaptive=True, window="step",
                               seed=2), "simulator step")
    _close_stats(base, jsim.run("roce", 120, seed=2), "simulator roce")


def test_sweep_refuses_step_window():
    with pytest.raises(ValueError, match="round' or 'phase"):
        tengine.sweep(tengine.BatchedSimParams(windows=("step",)),
                      device="cpu")


def test_smoke_fig2_step_window_key():
    """``smoke_fig2_beyond_step_window_reduction``: the 32-node fabric's
    legacy paper protocol and its adaptive step window, 60 rounds."""
    sim = TSim(figs.smoke_params(), device="cpu")
    roce = sim.paper_protocol(figs.FIG2_SMOKE_ROUNDS, 0)["roce"]
    keys, st, timing = figs.fig2_step_window(
        "cpu", roce.p99, params=figs.smoke_params(),
        n_rounds=figs.FIG2_SMOKE_ROUNDS, prefix="smoke_fig2")
    key = "smoke_fig2_beyond_step_window_reduction"
    assert keys == {key: _committed(key)} == {key: 1.17}
    assert timing["node_bytes"] > 0


# ------------------------------------------------------ priority classes

PLANS = [("ring", 1), ("hier", 2), ("hier", 4), ("perrail", 2)]


def _plans(schedule, npods):
    out = []
    for mod, sched_mod, topo in ((jparams, jschedule, jtopology),
                                 (tparams, tschedule, ttopology)):
        p = topo.hier_params(npods, base=_small(mod, nodes_per_tor=32
                                                // max(npods, 2)),
                             schedule=schedule) if npods > 1 else _small(mod)
        out.append((sched_mod.make_plan(p.net, p.topo, p.work), p.net,
                    sched_mod))
    return out


@pytest.mark.parametrize("schedule,npods", PLANS,
                         ids=[f"{s}{n}" for s, n in PLANS])
def test_layer_priorities_and_class_packets_match_numpy(schedule, npods):
    (jp, jnet, jsm), (tp, tnet, tsm) = _plans(schedule, npods)
    np.testing.assert_array_equal(tsm.layer_priorities(tp),
                                  jsm.layer_priorities(jp))
    assert tp.n_priority_classes() == jp.n_priority_classes()
    np.testing.assert_array_equal(tp.prio_pkts_round(tnet),
                                  jp.prio_pkts_round(jnet))
    over = tsm.with_step_priorities(tp, tsm.layer_priorities(tp))
    np.testing.assert_array_equal(
        over.prio_pkts_round(tnet),
        jsm.with_step_priorities(jp, jsm.layer_priorities(jp))
        .prio_pkts_round(jnet))
    assert over.prio_pkts_round(tnet).sum() == sum(
        ph.src.size * ph.n_pkts(tnet) * ph.n_steps for ph in tp.phases)


def test_layer_priorities_structure():
    """tests/test_schedule.py:421 on the port's plan."""
    hp = ttopology.hier_params(2, base=_small(tparams), schedule="hier")
    plan = tschedule.make_plan(hp.net, hp.topo, hp.work)
    cls = tschedule.layer_priorities(plan)
    phase_cls = plan.step_priority()
    assert cls.max() == phase_cls.max() + 1
    dci = np.array([plan.phases[k].name == "dci"
                    for k in plan.phase_of_step])
    np.testing.assert_array_equal(cls[dci], 0)
    ag = np.array([plan.phases[k].name.startswith("ag")
                   for k in plan.phase_of_step])
    n_top = int(round(ag.sum() * 0.5))
    assert (cls == cls.max()).sum() == n_top
    assert np.all(np.where(cls == cls.max())[0]
                  >= np.where(ag)[0][-1] - n_top)
    small = _small(tparams)
    ring = tschedule.RingSchedule().plan(small.net, small.topo, small.work)
    np.testing.assert_array_equal(tschedule.layer_priorities(ring),
                                  ring.step_priority())


def _priority_cell(eng, mod, sched_mod, topo_mod, npods, *, n_rounds=40,
                   seed=7, scale=0.5):
    """tests/test_schedule.py's ``_priority_cell`` on one engine: the
    hier cell with layer-depth classes, both cut orders at one budget,
    round and phase windows, fixed and adaptive."""
    hp = eng.p
    plan = sched_mod.make_plan(hp.net, hp.topo, hp.work)
    cls = sched_mod.layer_priorities(plan)
    tr = eng.traces(["roce", "celeris"], n_rounds, seed,
                    legacy_streams=False)
    cel = dataclasses.replace(tr["celeris"], step_priority=cls)
    base = eng.assemble(tr["roce"], seed)
    to = float((np.percentile(base.times_us, 50)
                + base.times_us.std()) * scale)
    return cls, {(o, w, a): eng.assemble(cel, seed, celeris_timeout_us=to,
                                         adaptive=a, window=w, cut_order=o)
                 for o in ("arrival", "priority") for w in ("round", "phase")
                 for a in (False, True)}


@pytest.fixture(scope="module")
def priority_cells():
    out = {}
    for npods in (2, 4):
        def params_of(mod, npods=npods):
            topo = jtopology if mod is jparams else ttopology
            return topo.hier_params(
                npods, base=_small(mod, nodes_per_tor=32 // npods),
                dci_oversubscription=8.0, schedule="hier")
        jeng, teng = _engines(params_of)
        out[npods] = (
            _priority_cell(jeng, jparams, jschedule, jtopology, npods),
            _priority_cell(teng, tparams, tschedule, ttopology, npods))
    return out


ORDERS = [(o, w, a) for o in ("arrival", "priority")
          for w in ("round", "phase") for a in (False, True)]


@pytest.mark.parametrize("npods", [2, 4])
@pytest.mark.parametrize("order,window,adaptive", ORDERS,
                         ids=[f"{o}-{w}-{'adaptive' if a else 'fixed'}"
                              for o, w, a in ORDERS])
def test_priority_cut_matches_numpy(priority_cells, npods, order, window,
                                    adaptive):
    (_, want), (_, got) = priority_cells[npods]
    _close_stats(got[order, window, adaptive], want[order, window, adaptive],
                 f"{npods} pods {order} {window} adaptive={adaptive}")


@pytest.mark.parametrize("npods", [2, 4])
def test_priority_cut_conserves_totals_vs_arrival(priority_cells, npods):
    """tests/test_schedule.py:351 on the port: at an equal budget the
    priority order cuts the same total bytes as arrival; only which
    class the cut lands on moves."""
    _, (cls, stats) = priority_cells[npods]
    arr, pri = stats["arrival", "round", False], stats[
        "priority", "round", False]
    np.testing.assert_array_equal(arr.times_us, pri.times_us)
    np.testing.assert_array_equal(arr.recv_frac, pri.recv_frac)
    assert arr.prio_pkts.size == int(cls.max()) + 1 == 3
    np.testing.assert_array_equal(arr.prio_pkts, pri.prio_pkts)
    got_arr = (arr.prio_recv_frac * arr.prio_pkts).sum(axis=1)
    got_pri = (pri.prio_recv_frac * pri.prio_pkts).sum(axis=1)
    np.testing.assert_allclose(got_pri, got_arr, rtol=1e-12, atol=1e-6)
    top = arr.prio_pkts.size - 1
    assert arr.prio_loss(top) > 0.0          # arrival cuts exact shards
    assert pri.prio_loss(top) <= arr.prio_loss(top)
    assert pri.prio_loss(0) >= arr.prio_loss(0)


def _flat_celeris(eng):
    tr = eng.traces(["roce", "celeris"], 40, seed=11, legacy_streams=False)
    base = eng.assemble(tr["roce"], 11)
    to = float(np.percentile(base.times_us, 50)
               + base.times_us.std()) * 0.8
    return tr["celeris"], dict(celeris_timeout_us=to, adaptive=False,
                               window="round")


def test_priority_cut_uniform_classes_match_arrival_bitexact():
    """tests/test_schedule.py:377 on the port: on the flat ring (one
    class) the priority cut lands on arrival's trailing steps."""
    _, teng = _engines(_small)
    cel, kw = _flat_celeris(teng)
    arr = teng.assemble(cel, 11, cut_order="arrival", **kw)
    pri = teng.assemble(cel, 11, cut_order="priority", **kw)
    assert arr.recv_frac.min() < 1.0
    np.testing.assert_array_equal(arr.times_us, pri.times_us)
    np.testing.assert_array_equal(arr.recv_frac, pri.recv_frac)
    np.testing.assert_allclose(pri.tier_recv_frac, arr.tier_recv_frac,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(pri.prio_recv_frac, arr.prio_recv_frac,
                               rtol=0, atol=1e-12)


def test_arrival_cut_with_priority_metadata_is_pinned():
    """tests/test_schedule.py:399 on the port: an explicit arrival cut
    over a trace that carries priority metadata is the cut without it,
    bit for bit, and the committed seed stats within the contract."""
    with open(os.path.join(DATA, "ring_schedule_seed_stats.json")) as f:
        ref = json.load(f)["flat"]
    _, teng = _engines(_small)
    cel, kw = _flat_celeris(teng)
    assert cel.step_priority is not None          # engine-attached
    with_meta = teng.assemble(cel, 11, cut_order="arrival", **kw)
    bare = teng.assemble(dataclasses.replace(cel, step_priority=None), 11,
                         **kw)
    np.testing.assert_array_equal(with_meta.times_us, bare.times_us)
    np.testing.assert_array_equal(with_meta.recv_frac, bare.recv_frac)
    np.testing.assert_array_equal(with_meta.tier_recv_frac,
                                  bare.tier_recv_frac)
    assert kw["celeris_timeout_us"] == pytest.approx(
        ref["celeris_timeout_us"], rel=RTOL)
    np.testing.assert_allclose(with_meta.times_us, ref["celeris_times_us"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(with_meta.recv_frac, ref["celeris_recv_frac"],
                               rtol=RTOL, atol=0)


GUARDS = {
    "unknown_order": (dict(cut_order="random"), "cut_order must be"),
    "no_step_priority": (dict(cut_order="priority", bare=True,
                              celeris_timeout_us=30_000.0, adaptive=False),
                         "step_priority"),
    "priority_step_window": (dict(cut_order="priority", window="step",
                                  celeris_timeout_us=30_000.0,
                                  adaptive=False), "step window"),
    "step_without_per_flow": (dict(window="step", adaptive=False),
                              "per-flow"),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_priority_cut_guards(case):
    """tests/test_schedule.py:444: the same ``ValueError`` from both
    engines."""
    kw, match = dict(GUARDS[case][0]), GUARDS[case][1]
    bare = kw.pop("bare", False)
    for eng in _engines(_small):
        tr = eng.traces(["celeris"], 5, 0, legacy_streams=False)["celeris"]
        if bare:
            tr = dataclasses.replace(tr, step_priority=None)
        with pytest.raises(ValueError, match=match):
            eng.assemble(tr, 0, **kw)


@pytest.mark.parametrize("bad,match", [(np.zeros(3, dtype=int), "shape"),
                                       (None, ">= 0")])
def test_with_step_priorities_guards(bad, match):
    small = _small(tparams)
    plan = tschedule.make_plan(small.net, small.topo, small.work)
    if bad is None:
        bad = -np.ones(plan.steps_per_round, dtype=int)
    with pytest.raises(ValueError, match=match):
        tschedule.with_step_priorities(plan, bad)


def test_priority_schedules_match_numpy(priority_cells):
    """Per-class drop schedules from the priority cut: the port's against
    the numpy engine's stats, and the refusal without per-class
    fractions."""
    (_, want), (_, got) = priority_cells[2]
    key = ("priority", "round", False)
    a = tcoupling.priority_schedules_from_round_stats(got[key])
    b = jcoupling.priority_schedules_from_round_stats(want[key])
    assert a.n_classes == b.n_classes == 3
    np.testing.assert_array_equal(a.pkts, b.pkts)
    for x, y in zip(a.classes, b.classes):
        np.testing.assert_allclose(x.rates, y.rates, rtol=RTOL, atol=1e-12)
        assert x.source == y.source
    assert a.low is a.classes[0] and a.high is a.classes[-1]
    np.testing.assert_allclose(a.rates(3), b.rates(3), rtol=RTOL, atol=1e-12)
    assert a.high.mean <= a.low.mean
    bare = dataclasses.replace(got[key], prio_recv_frac=None)
    with pytest.raises(ValueError, match="per-priority-class"):
        tcoupling.priority_schedules_from_round_stats(bare)


def test_hier_protocol_priority_cut_matches_numpy():
    """``hier_protocol(cut_order="priority")`` on the hier plan's own
    phase classes (dci below rs/ag)."""
    def params_of(mod):
        topo = jtopology if mod is jparams else ttopology
        return topo.hier_params(2, base=_small(mod), schedule="hier",
                                dci_oversubscription=8.0)
    want = jtopology.hier_protocol(params_of(jparams), 30, 5,
                                   timeout_scale=0.5, cut_order="priority")
    got = ttopology.hier_protocol(params_of(tparams), 30, 5,
                                  timeout_scale=0.5, cut_order="priority",
                                  device="cpu")
    for d in ("roce", "celeris"):
        _close_stats(got[d], want[d], d)


# ------------------------------------------------------------- Fig. 10

def test_smoke_fig10_keys_exact():
    """``smoke_fig10_*``: the 2-pod 32-node cell, all six keys at the
    committed digits."""
    keys, stats = figs.smoke_fig10_keys("cpu")
    assert len(keys) == 6
    assert keys == {k: _committed(k) for k in keys}
    np.testing.assert_array_equal(stats["arrival"].times_us,
                                  stats["priority"].times_us)


def test_fig10_full_tier_cell_exact():
    """One full-tier cell (128 nodes, 4 pods, oversubscription 2, 40
    rounds): its six ``fig10_*`` keys at the committed digits, the ratio
    above the reference's bar, and the same keys as the reference
    script's protocol on the numpy engine."""
    keys, cells = figs.fig10_keys("cpu", nodes=(128,), oversubs=(2.0,))
    assert keys == {k: _committed(k) for k in keys} and len(keys) == 6
    assert keys["fig10_hi_loss_ratio_n128_o2"] >= figs.FIG10_RATIO_BAR
    stats, timing = cells["n128_o2"]
    assert timing["blocks"] >= 1
    p = jtopology.hier_params(4, n_nodes=128, dci_oversubscription=2.0,
                              schedule="hier")
    p99_ms, want = jfig10._cell(p, 40, 0, jfig10.FIG10_TAIL_SCALE)
    for o in ("arrival", "priority"):
        _close_stats(stats[o], want[o], o)


def test_fig10_protocol_constants_match_reference():
    from benchmarks import budgets
    assert (figs.FIG10_NODES, figs.FIG10_OVERSUBS, figs.FIG10_PODS) == (
        jfig10.NODES, jfig10.OVERSUBS, jfig10.N_PODS)
    assert (figs.FIG10_RATIO_CAP, figs.FIG10_EPS) == (jfig10.RATIO_CAP,
                                                      jfig10._EPS)
    assert (figs.FIG10_TAIL_SCALE, figs.SMOKE_TAIL_SCALE, figs.TAIL_SCALE) == (
        budgets.FIG10_TAIL_SCALE, budgets.SMOKE_TAIL_SCALE,
        budgets.TAIL_SCALE)
    mine, theirs = figs.smoke_params().net, jfig10.SMOKE_PARAMS.net
    assert (mine.n_nodes, mine.burst_on_prob) == (theirs.n_nodes,
                                                  theirs.burst_on_prob)
