"""The port's fault injection and parameter sweep
(``repro_torch.core.transport.faults``, ``engine.sweep``) against the JAX
package's numpy engine, on the CPU.

The reference is the numpy ``BatchedEngine`` with
``legacy_streams=False``: the port's host pass draws the same fault
masks from the same substreams, so the faulted-flow counts and the
delivered packets per step are exact; times and fractions within rtol
1e-5 (the engine's contract, ``tests/test_torch_engine.py``).  Fabrics
are 32 nodes and at most 40 rounds.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import budgets
from benchmarks import fig7_fault_resilience as fig7
from repro.core.transport import engine as jengine
from repro.core.transport import faults as jfaults
from repro.core.transport import params as jparams
from repro.core.transport import topology as jtopology
from repro.core.transport.designs import TransferResult
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import faults as tfaults
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport import topology as ttopology
from test_torch_topology import DESIGNS, check_stats, check_traces

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-5
ROUNDS = 30


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(mod, topo_mod, n_pods, schedule, fault):
    base = mod.SimParams(net=mod.NetworkParams(
        n_nodes=32, burst_on_prob=0.0008,
        nodes_per_tor=16 if n_pods <= 2 else 8))
    if n_pods == 1:
        return dataclasses.replace(
            base, work=dataclasses.replace(base.work, schedule=schedule),
            fault=mod.FaultParams.parse(fault))
    return topo_mod.hier_params(n_pods, base=base, dci_oversubscription=2.0,
                                schedule=schedule, fault=fault)


# (pods, schedule, fault spec): every kind, on the fabrics it acts on
FAULT_CELLS = {
    "stall": (2, "hier", "stall:0.003"),
    "crash_restart": (2, "hier", jparams.FaultParams(
        crash_rate=0.001, crash_restart_steps=64)),
    "crash_permanent": (2, "ring", "crash:0.0003"),
    "flap": (2, "hier", "flap:0.003"),
    "rail_hier": (2, "hier", "rail:0.3"),
    "rail_perrail": (4, "perrail", "rail:0.3"),
    "straggler": (1, "ring", "straggler:0.1"),
    "stall+flap_perrail": (4, "perrail", "stall:0.001+flap:0.001"),
    "targeted_stall": (2, "ring", jparams.FaultParams(
        stall_rate=0.01, target_nodes=tuple(range(16)))),
}


def _spec(mod, spec):
    """A fault spec string, or the JAX FaultParams rebuilt from ``mod``."""
    if isinstance(spec, str):
        return spec
    return mod.FaultParams(**dataclasses.asdict(spec))


@pytest.fixture(scope="module")
def fault_runs():
    cache = {}

    def get(name):
        if name not in cache:
            n_pods, sched, spec = FAULT_CELLS[name]
            jeng = jengine.BatchedEngine(_params(
                jparams, jtopology, n_pods, sched, _spec(jparams, spec)))
            teng = tengine.BatchedEngine(_params(
                tparams, ttopology, n_pods, sched, _spec(tparams, spec)),
                device="cpu")
            cache[name] = (jeng, jeng.traces(DESIGNS, ROUNDS, 7,
                                              legacy_streams=False),
                           teng, teng.traces(DESIGNS, ROUNDS, 7,
                                             legacy_streams=False))
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(FAULT_CELLS))
def test_fault_kind_matches_numpy_engine(fault_runs, name):
    """Faulted flows per step and delivered packets exact, step times
    within rtol 1e-5, every design; flows are hit (a straggler is a rate
    scale, not an outage: it hits none)."""
    jeng, jtr, teng, ttr = fault_runs(name)
    check_traces(ttr, jtr)
    hit = ttr["celeris"].fault_flows.sum()
    assert hit == 0 if name == "straggler" else hit > 0


@pytest.mark.parametrize("window", ["round", "phase"])
@pytest.mark.parametrize("name", sorted(FAULT_CELLS))
def test_faulted_assembly_matches_numpy_engine(fault_runs, name, window):
    """Round stats of every design, Celeris at a window that binds, and
    the Fig.-7 metrics read from them."""
    jeng, jtr, teng, ttr = fault_runs(name)
    base = jeng.assemble(jtr["roce"], 7)
    to = float(np.percentile(base.times_us, 50) + base.times_us.std()) * 0.5
    for d in DESIGNS:
        kw = (dict(celeris_timeout_us=to, adaptive=False, window=window)
              if d == "celeris" else {})
        want, got = jeng.assemble(jtr[d], 7, **kw), teng.assemble(ttr[d], 7,
                                                                  **kw)
        check_stats(got, want, f"{name} {d}")
        np.testing.assert_array_equal(got.faulted, want.faulted)
        for f in ("goodput_under_failure", "mean_loss"):
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=RTOL, abs=1e-12), f
        assert got.recovery_rounds() == pytest.approx(want.recovery_rounds(),
                                                      abs=1e-9)
        np.testing.assert_allclose(got.goodput_trace(), want.goodput_trace(),
                                   rtol=RTOL)


def test_zero_fault_params_reproduce_pinned_flat_stats():
    """An explicit FaultParams() draws nothing: the pinned shared-fabric
    flat ring (seed 11, 40 rounds, window scale 0.8), no fault fields."""
    ref = json.load(open(os.path.join(
        DATA, "ring_schedule_seed_stats.json")))["flat"]
    p = tparams.SimParams(net=tparams.NetworkParams(n_nodes=32,
                                                    burst_on_prob=0.0008),
                          fault=tparams.FaultParams())
    eng = tengine.BatchedEngine(p, device="cpu")
    tr = eng.traces(["roce", "celeris"], 40, 11, legacy_streams=False)
    assert tr["celeris"].fault_flows is None
    base = eng.assemble(tr["roce"], 11)
    to = float(np.percentile(base.times_us, 50) + base.times_us.std()) * 0.8
    cel = eng.assemble(tr["celeris"], 11, celeris_timeout_us=to,
                       adaptive=False, window="round")
    np.testing.assert_allclose(base.times_us, ref["roce_times_us"],
                               rtol=RTOL)
    np.testing.assert_allclose(cel.times_us, ref["celeris_times_us"],
                               rtol=RTOL)
    np.testing.assert_allclose(cel.recv_frac, ref["celeris_recv_frac"],
                               rtol=RTOL)
    assert cel.fault_steps is None and not cel.faulted.any()
    assert cel.goodput_under_failure == 1.0 and cel.recovery_rounds() == 0.0


# --------------------------------------------------- params and masks

@pytest.mark.parametrize("spec", ["stall:0.001", "crash:3e-05",
                                  "flap:0.0005", "rail:0.3",
                                  "straggler:0.25",
                                  "stall:0.001+flap:0.0005",
                                  "rail:0.1+crash:1e-4", "stall"])
def test_fault_params_parse_matches_jax(spec):
    got, want = tparams.FaultParams.parse(spec), jparams.FaultParams.parse(
        spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.tag, got.active) == (want.tag, want.active)


@pytest.mark.parametrize("kind", tparams.FaultParams.KINDS)
def test_fault_params_of_kind_matches_jax(kind):
    kw = {"crash_restart_steps": 64} if kind == "crash" else {}
    got = tparams.FaultParams.of_kind(kind, 0.02, **kw)
    want = jparams.FaultParams.of_kind(kind, 0.02, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.tag == want.tag
    with pytest.raises(ValueError, match="unknown fault kind"):
        tparams.FaultParams.of_kind("meteor", 0.1)
    with pytest.raises(ValueError):
        tparams.FaultParams(stall_rate=1.5)


def test_fault_stream_ids_match_jax():
    for name in ("STREAM_STALL", "STREAM_CRASH", "STREAM_FLAP",
                 "STREAM_FLAP_DCI", "STREAM_RAIL", "STREAM_STRAGGLER"):
        assert getattr(tfaults, name) == getattr(jfaults, name)


@pytest.mark.parametrize("spec", ["stall:0.01", "crash:0.002", "flap:0.01",
                                  "rail:0.5", "straggler:0.2",
                                  "stall:0.01+crash:0.002+flap:0.01"])
def test_fault_model_masks_match_jax(spec):
    """The masks of three consecutive blocks (state carried), per phase
    of the perrail plan on 4 pods, equal the JAX package's bit for bit."""
    pj = _params(jparams, jtopology, 4, "perrail", spec)
    pt = _params(tparams, ttopology, 4, "perrail", spec)
    plan = jengine.schedule_mod.make_plan(pj.net, pj.topo, pj.work)
    hgs = plan.geometries(pj.net, pj.topo)
    steps = plan.steps_per_round
    jm = jfaults.FaultModel(pj, 3, 32, 4, steps)
    tm = tfaults.FaultModel(pt, 3, 32, 4, steps)
    if jm.rate_scale is None:
        assert tm.rate_scale is None
    else:
        np.testing.assert_array_equal(tm.rate_scale, jm.rate_scale)
    for t0 in range(0, 3 * 5 * steps, 5 * steps):
        jb, tb = jm.advance(t0, 5 * steps), tm.advance(t0, 5 * steps)
        for f in ("node_blocked", "node_dead", "tor_down", "dci_down",
                  "rail_down"):
            a, b = getattr(tb, f), getattr(jb, f)
            assert (a is None) == (b is None), f
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        for k, (ph, hg) in enumerate(zip(plan.phases, hgs)):
            rows = (np.arange(0, 5 * steps, steps)[:, None]
                    + np.flatnonzero(plan.phase_of_step == k)[None]).ravel()
            for a, b in zip(tm.phase_masks(tb, rows, ph, hg, 8),
                            jm.phase_masks(jb, rows, ph, hg, 8)):
                assert (a is None) == (b is None)
                if b is not None:
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("which", ["blocked", "dead", "both", "none"])
def test_apply_to_result_matches_jax(design, which):
    """The one formula the device core applies, on numpy arrays, equals
    the JAX package's in-place overlay bit for bit."""
    rng = np.random.default_rng(2)
    shape = (40, 16)
    t = (rng.random(shape) * 100).astype(np.float32)
    deliv = (np.full(shape, 50.0, np.float32) if design == "celeris"
             else np.broadcast_to(np.float64(50), shape))
    hit = rng.random(shape) < 0.2
    dead = (hit & (rng.random(shape) < 0.5)
            if which in ("dead", "both") else None)
    blocked = ((hit & ~dead if dead is not None else hit)
               if which in ("blocked", "both") else None)
    rel = jparams.ReliabilityParams()
    res = TransferResult(t.copy(), deliv.copy() if design == "celeris"
                         else deliv, np.broadcast_to(np.float64(50), shape))
    jfaults.apply_to_result(design, res, blocked, dead, rel)
    got_t, got_d = tfaults.apply_to_result(
        design, t.copy(), deliv.copy() if design == "celeris" else None,
        blocked, dead, tparams.ReliabilityParams())
    assert got_t.dtype == np.float32
    np.testing.assert_array_equal(got_t, res.time_us)
    if design == "celeris":
        np.testing.assert_array_equal(got_d, res.delivered_pkts)
    # the same formula on torch tensors (the device core's form)
    tt_t, tt_d = tfaults.apply_to_result(
        design, torch.from_numpy(t.copy()),
        torch.from_numpy(deliv.copy()) if design == "celeris" else None,
        None if blocked is None else torch.from_numpy(blocked),
        None if dead is None else torch.from_numpy(dead),
        tparams.ReliabilityParams())
    np.testing.assert_array_equal(tt_t.numpy(), res.time_us)
    if design == "celeris":
        np.testing.assert_array_equal(tt_d.numpy(), res.delivered_pkts)


def test_round_stats_fault_metrics_match_jax():
    """RoundStats' Fig.-7 metrics on the same arrays."""
    rng = np.random.default_rng(5)
    kw = dict(times_us=rng.random(50) * 1e3 + 100,
              recv_frac=1 - rng.random(50) * 0.3, design="celeris",
              tier_recv_frac=rng.random((50, 3)),
              tier_counts=np.array([4, 0, 2]),
              fault_steps=(rng.random(50) < 0.3).astype(int) * 3)
    got, want = tengine.RoundStats(**kw), jengine.RoundStats(**kw)
    np.testing.assert_array_equal(got.goodput_trace(), want.goodput_trace())
    assert got.goodput_under_failure == want.goodput_under_failure
    for frac in (0.5, 0.9, 0.99):
        assert got.recovery_rounds(frac) == want.recovery_rounds(frac)
    assert got.summary() == want.summary()
    for tier in ("tor", "spine", "dci"):
        assert got.tier_loss(tier) == want.tier_loss(tier)


# --------------------------------------------------------------- sweep

def _both_sweeps(**kw):
    base_j = jparams.SimParams(net=jparams.NetworkParams(
        n_nodes=32, burst_on_prob=0.0008))
    base_t = tparams.SimParams(net=tparams.NetworkParams(
        n_nodes=32, burst_on_prob=0.0008))
    want = jengine.sweep(jengine.BatchedSimParams(base=base_j, **kw))
    got = tengine.sweep(tengine.BatchedSimParams(base=base_t, **kw),
                        device="cpu")
    assert sorted(got.stats) == sorted(want.stats)
    for key, w in want.stats.items():
        check_stats(got.stats[key], w, str(key))
    return got, want


def test_sweep_fault_axis_keys_and_clean_cell():
    """The fault dimension: keys end in the FaultParams tag; the clean
    cell of a faulted grid equals the grid without the fault axis."""
    kw = dict(n_nodes=(32,), seeds=(0, 1), n_pods=(2,), schedules=("hier",),
              designs=("roce", "celeris"), n_rounds=12,
              timeout_scale=0.5)
    got, want = _both_sweeps(faults=(None, "stall:0.003"), **kw)
    assert got.fault_tags() == want.fault_tags() == ("none", "stall:0.003")
    assert ("celeris", 32, 25.0, 1, 2, "hier", "stall:0.003") in got.stats
    clean = tengine.sweep(tengine.BatchedSimParams(
        base=tparams.SimParams(net=tparams.NetworkParams(
            n_nodes=32, burst_on_prob=0.0008)), **kw), device="cpu")
    for d in ("roce", "celeris"):
        for s in (0, 1):
            a = got.stats[(d, 32, 25.0, s, 2, "hier", "none")]
            b = clean.stats[(d, 32, 25.0, s, 2, "hier")]
            np.testing.assert_array_equal(a.times_us, b.times_us)
            np.testing.assert_array_equal(a.recv_frac, b.recv_frac)
    assert len(got.timing) == 2 and all(
        t["seeds"] == 2 for t in got.timing.values())


def test_sweep_grid_axes_match_jax():
    """Pods, schedules and windows: keys, stats and the p99 helpers."""
    got, want = _both_sweeps(
        n_nodes=(32,), seeds=(0, 1), n_pods=(1, 2),
        schedules=("ring", "perrail"), windows=("round", "phase"),
        designs=("roce", "irn", "celeris"), n_rounds=8, timeout_scale=0.6)
    for fn, kw in (("p99_vs_pods", {}), ("p99_vs_schedule", {"n_pods": 2}),
                   ("p99_vs_window", {"n_pods": 2, "schedule": "perrail"}),
                   ("p99_vs_scale", {"window": "phase"})):
        g, w = getattr(got, fn)("celeris", **kw), getattr(want, fn)(
            "celeris", **kw)
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL)
    assert [r[:-3] for r in got.summary_rows()] == [
        r[:-3] for r in want.summary_rows()]


def test_sweep_refusals():
    """The numpy engine's refusals: legacy streams exist only on the
    flat, fault-free ring; the step window needs per-flow traces."""
    for kw, what in (({"n_pods": (1, 2)}, "n_pods"),
                     ({"schedules": ("ring", "hier")}, "schedule"),
                     ({"faults": (None, "stall:1e-4")}, "fault")):
        with pytest.raises(ValueError, match=what):
            tengine.sweep(tengine.BatchedSimParams(legacy_streams=True,
                                                   **kw), device="cpu")
    with pytest.raises(ValueError, match="window"):
        tengine.sweep(tengine.BatchedSimParams(windows=("step",)),
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tengine.sweep(tengine.BatchedSimParams(n_rounds=1))


# ------------------------------------------------- smoke Fig. 7

def test_smoke_fig7_quantities_match_numpy_engine():
    """fig7_fault_resilience.py's smoke tier (32 nodes, 2 pods,
    oversubscription 2, stall at SMOKE_RATES, pinned budget), its clean
    pass and fault sweep run by chip_smoke's Fig.-7 helpers through the
    port's sweep, against the benchmark's own on the numpy engine."""
    jbase = jtopology.hier_params(2, base=fig7.SMOKE_PARAMS,
                                  dci_oversubscription=fig7.SMOKE_OVERSUB)
    tbase = ttopology.hier_params(2, base=tparams.SimParams(
        net=tparams.NetworkParams(n_nodes=32, burst_on_prob=0.0008)),
        dci_oversubscription=fig7.SMOKE_OVERSUB)
    jclean, jbudget = fig7._clean_pass(jbase, 32, 2, "hier", 40, 0,
                                       fig7.SMOKE_TAIL_SCALE)
    tclean, tbudget, _ = chip_smoke.fig7_clean_pass(
        tengine, tbase, 32, 2, "hier", 40, 0, fig7.SMOKE_TAIL_SCALE, "cpu")
    assert tbudget == pytest.approx(jbudget, rel=RTOL)
    kinds = [("stall", r) for r in fig7.SMOKE_RATES]
    jcells = fig7._fault_sweep(jbase, 32, 2, "hier", kinds, jbudget, 40, 0)
    tcells, _ = chip_smoke.fig7_fault_sweep(tengine, tparams, tbase, 32, 2,
                                            "hier", kinds, jbudget, 40, 0,
                                            "cpu")
    for d in ("roce", "celeris"):
        check_stats(tclean[d], jclean[d], f"clean {d}")
    for kr in kinds:
        for d in ("roce", "celeris"):
            check_stats(tcells[kr][d], jcells[kr][d], f"{kr} {d}")
            assert chip_smoke.fig7_sustained(tcells[kr][d], tclean[d]) == \
                fig7._sustained(jcells[kr][d], jclean[d])
        assert chip_smoke.fig7_gupf(
            tcells[kr]["celeris"], tclean["celeris"]) == pytest.approx(
            fig7._gupf(jcells[kr]["celeris"], jclean["celeris"]), rel=RTOL)
    rates = fig7.SMOKE_RATES
    for d in ("roce", "celeris"):
        assert chip_smoke.fig7_max_sustained(
            {r: tcells[("stall", r)][d] for r in rates}, tclean[d],
            rates) == fig7._max_sustained(
            {r: jcells[("stall", r)][d] for r in rates}, jclean[d], rates)
    hi = tcells[("stall", rates[-1])]
    assert chip_smoke.fig7_sustained(hi["celeris"], tclean["celeris"])
    # the protocol's constants are the benchmark's
    assert chip_smoke.FIG7_RATE_GRID == fig7.RATE_GRID
    assert chip_smoke.FIG7_FAULT_KW == fig7.FAULT_KW
    assert chip_smoke.FIG7_RAIL_RATES == fig7.RAIL_RATES
    assert chip_smoke.FIG7_PAPER_CELL == fig7.PAPER_CELL
    assert (chip_smoke.FIG7_NODES, chip_smoke.FIG7_PODS,
            chip_smoke.FIG7_OVERSUB, chip_smoke.FIG7_SCALE_NODES) == (
        fig7.NODES, fig7.N_PODS, fig7.OVERSUB, fig7.SCALE_NODES)
    assert (chip_smoke.FIG7_P99_SLACK, chip_smoke.FIG7_GOODPUT_FLOOR) == (
        fig7.P99_SLACK, fig7.GOODPUT_FLOOR)
    assert chip_smoke.FIG7_TAIL_SCALE == budgets.TAIL_SCALE
    assert chip_smoke.rate_tag(3e-5) == fig7._rtag(3e-5)
