"""The port's hierarchical fabric (``repro_torch.core.transport``: the DCI
tier, the ``hier`` and ``perrail`` schedules, the phase window) against
the numpy engine of the JAX package, on the CPU.

The reference is the numpy ``BatchedEngine`` with
``legacy_streams=False`` and the pinned
``tests/data/ring_schedule_seed_stats.json["pods2"]`` (the flat ring over
two pods, in that mode).  Tolerances are the engine's contract
(``tests/test_torch_engine.py``): delivered packets per step, per tier
and per pod exact; rtol 1e-5 on times, p99 and delivered fractions.
Fabrics are 32 nodes (4 pods align to ToRs of 8) and at most 40 rounds:
the plain DCQCN scan takes ~0.3 ms a step on the CPU.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core.transport import engine as jengine
from repro.core.transport import params as jparams
from repro.core.transport import schedule as jschedule
from repro.core.transport import topology as jtopology
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport import schedule as tschedule
from repro_torch.core.transport import topology as ttopology

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-5
DESIGNS = ("roce", "irn", "srnic", "celeris")
ROUNDS = 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(mod, nodes_per_tor=16):
    """tests/test_schedule.py's SMALL fabric from ``mod``'s params; 4 pods
    of 8 nodes need ToRs of 8."""
    return mod.SimParams(net=mod.NetworkParams(
        n_nodes=32, burst_on_prob=0.0008, nodes_per_tor=nodes_per_tor))


def _hier(mod, topo_mod, n_pods, schedule, **kw):
    base = _small(mod, 16 if n_pods <= 2 else 32 // n_pods)
    return topo_mod.hier_params(n_pods, base=base, schedule=schedule, **kw)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=0, err_msg=what)


TRACE_FIELDS = ("deliv", "total", "tier_deliv", "tier_total", "pod_deliv",
                "pod_total", "fault_flows")


def check_traces(got, want):
    """Delivered and offered sums exact; step times within rtol."""
    for d, w in want.items():
        g = got[d]
        for f in TRACE_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), (d, f)
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{d} {f}")
        _close(g.nat_us, w.nat_us, f"{d} nat_us")
        np.testing.assert_array_equal(g.tier_counts, w.tier_counts)
        np.testing.assert_array_equal(g.tier_pkts_round, w.tier_pkts_round)
        if w.pod_pkts_round is not None:
            np.testing.assert_array_equal(g.pod_pkts_round, w.pod_pkts_round)


STAT_FIELDS = ("times_us", "recv_frac", "tier_recv_frac", "pod_recv_frac",
               "prio_recv_frac")


def check_stats(got, want, what):
    for f in STAT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), (what, f)
        if b is not None:
            _close(a, b, f"{what} {f}")
    _close(got.p99, want.p99, f"{what} p99")
    for f in ("fault_steps", "affected_flows", "pod_pkts", "prio_pkts"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), (what, f)
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


# ------------------------------------------------------------- pinned

def test_ring_over_two_pods_reproduces_pinned_seed_stats():
    """``["pods2"]``: the ring over the 2-pod DCI overlay (oversubscription
    8, seed 11, 40 rounds, window scale 0.8), tier fractions included."""
    ref = json.load(open(os.path.join(
        DATA, "ring_schedule_seed_stats.json")))["pods2"]
    hp = ttopology.hier_params(2, base=_small(tparams),
                               dci_oversubscription=8.0)
    stats = ttopology.hier_protocol(hp, n_rounds=40, seed=11,
                                    timeout_scale=0.8, device="cpu")
    _close(stats["roce"].times_us, ref["roce_times_us"], "roce times")
    _close(stats["celeris"].times_us, ref["celeris_times_us"],
           "celeris times")
    _close(stats["celeris"].recv_frac, ref["celeris_recv_frac"],
           "celeris recv_frac")
    _close(stats["celeris"].tier_recv_frac, ref["celeris_tier_recv_frac"],
           "celeris tier_recv_frac")
    assert stats["celeris"].tier_loss("dci") > 0     # the DCI tier loses


# ------------------------------------------- engine against numpy

@pytest.fixture(scope="module")
def hier_traces():
    """One trace pass per (schedule, pods) on each side, shared by the
    window tests."""
    cache = {}

    def get(schedule, n_pods):
        if (schedule, n_pods) not in cache:
            pj = _hier(jparams, jtopology, n_pods, schedule,
                       dci_oversubscription=2.0)
            pt = _hier(tparams, ttopology, n_pods, schedule,
                       dci_oversubscription=2.0)
            jeng = jengine.BatchedEngine(pj)
            teng = tengine.BatchedEngine(pt, device="cpu")
            cache[(schedule, n_pods)] = (
                jeng, jeng.traces(DESIGNS, ROUNDS, 3, legacy_streams=False),
                teng, teng.traces(DESIGNS, ROUNDS, 3, legacy_streams=False))
        return cache[(schedule, n_pods)]
    return get


@pytest.mark.parametrize("n_pods", [2, 4])
@pytest.mark.parametrize("schedule", ["hier", "perrail"])
def test_hier_schedule_traces_match_numpy_engine(hier_traces, schedule,
                                                 n_pods):
    """All four designs: per-step, per-tier and per-pod delivered packets
    exact, step times within rtol 1e-5."""
    _, jtr, _, ttr = hier_traces(schedule, n_pods)
    check_traces(ttr, jtr)
    assert ttr["celeris"].pod_deliv.shape == (ROUNDS * ttr[
        "celeris"].steps_per_round, n_pods)


@pytest.mark.parametrize("window", ["round", "phase"])
@pytest.mark.parametrize("n_pods", [2, 4])
@pytest.mark.parametrize("schedule", ["hier", "perrail"])
def test_hier_schedule_assembly_matches_numpy_engine(hier_traces, schedule,
                                                     n_pods, window):
    """Every design's round stats, and Celeris under the fixed and the
    adaptive window of each policy, at a budget that binds."""
    jeng, jtr, teng, ttr = hier_traces(schedule, n_pods)
    for d in DESIGNS:
        check_stats(teng.assemble(ttr[d], 3), jeng.assemble(jtr[d], 3), d)
    base = jeng.assemble(jtr["roce"], 3)
    to = float(np.percentile(base.times_us, 50) + base.times_us.std()) * 0.6
    for adaptive in (False, True):
        kw = dict(celeris_timeout_us=to, adaptive=adaptive, window=window)
        want = jeng.assemble(jtr["celeris"], 3, **kw)
        got = teng.assemble(ttr["celeris"], 3, **kw)
        assert want.recv_frac.min() < 1.0              # the window binds
        check_stats(got, want, f"celeris adaptive={adaptive}")


def test_per_pod_oversubscription_vector_matches_numpy_engine():
    """A hot pod (oversubscription (2, 6)) on the ring over two pods: the
    per-flow factor is the worse endpoint's."""
    kw = dict(dci_oversubscription=(2.0, 6.0), dci_burst_on_prob=(0.003,
                                                                  0.01))
    jeng = jengine.BatchedEngine(_hier(jparams, jtopology, 2, "ring", **kw))
    teng = tengine.BatchedEngine(_hier(tparams, ttopology, 2, "ring", **kw),
                                 device="cpu")
    check_traces(teng.traces(DESIGNS, 16, 5, legacy_streams=False),
                 jeng.traces(DESIGNS, 16, 5, legacy_streams=False))


def test_hier_protocol_matches_numpy_engine():
    """hier_protocol's RoCE baseline and the window it fixes, on the
    hier schedule with the phase window."""
    pj = _hier(jparams, jtopology, 2, "hier", dci_oversubscription=4.0)
    pt = _hier(tparams, ttopology, 2, "hier", dci_oversubscription=4.0)
    want = jtopology.hier_protocol(pj, 30, 2, timeout_scale=0.7,
                                   window="phase")
    got = ttopology.hier_protocol(pt, 30, 2, timeout_scale=0.7,
                                  window="phase", device="cpu")
    for d in ("roce", "celeris"):
        check_stats(got[d], want[d], d)
        assert got[d].tier_loss("dci") == pytest.approx(
            want[d].tier_loss("dci"), rel=RTOL, abs=1e-12)


def test_flat_traces_immune_to_dci_parameters():
    """At one pod the DCI tier draws nothing and changes nothing."""
    base = _small(tparams)
    hot = dataclasses.replace(base, topo=tparams.TopologyParams(
        n_pods=1, dci_oversubscription=8.0, dci_burst_on_prob=0.5,
        dci_rtt_us=100.0))
    a = tengine.BatchedEngine(base, device="cpu").traces(
        DESIGNS, 10, 4, legacy_streams=False)
    b = tengine.BatchedEngine(hot, device="cpu").traces(
        DESIGNS, 10, 4, legacy_streams=False)
    for d in DESIGNS:
        np.testing.assert_array_equal(a[d].nat_us, b[d].nat_us)
        np.testing.assert_array_equal(a[d].deliv, b[d].deliv)
        assert a[d].pod_deliv is None and b[d].pod_deliv is None


# ---------------------------------------------------- plans, overlay

PLAN_CASES = [(32, 2, 16), (32, 4, 8), (64, 2, 16), (128, 8, 16),
              (32, 32, 1)]


@pytest.mark.parametrize("schedule", ["ring", "hier", "perrail"])
@pytest.mark.parametrize("n,n_pods,per_tor", PLAN_CASES)
def test_plan_matches_make_plan(schedule, n, n_pods, per_tor):
    """Step counts, phase map, flows, payloads, budget split, priority
    classes and every tier / pod map equal the JAX package's plan."""
    plans = []
    for mod, topo_mod, sched_mod in ((jparams, jtopology, jschedule),
                                     (tparams, ttopology, tschedule)):
        p = topo_mod.hier_params(
            n_pods, schedule=schedule, dci_oversubscription=(3.0,) * n_pods,
            base=mod.SimParams(net=mod.NetworkParams(
                n_nodes=n, nodes_per_tor=per_tor)))
        plan = sched_mod.make_plan(p.net, p.topo, p.work)
        plans.append((plan, plan.geometries(p.net, p.topo), p))
    (want, jg, pj), (got, tg, pt) = plans
    assert got.schedule == want.schedule
    assert got.steps_per_round == want.steps_per_round
    np.testing.assert_array_equal(got.phase_of_step, want.phase_of_step)
    np.testing.assert_array_equal(got.step_priority(), want.step_priority())
    np.testing.assert_array_equal(got.budget_fracs(), want.budget_fracs())
    for a, b in zip(got.phases, want.phases):
        assert (a.name, a.n_steps, a.payload_bytes, a.priority) == (
            b.name, b.n_steps, b.payload_bytes, b.priority)
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.tiers, b.tiers)
        for x, y in zip(a.tier_cols + a.pod_cols, b.tier_cols + b.pod_cols):
            np.testing.assert_array_equal(x, y)
    for f in ("tier_counts", "tier_pkts_round", "pod_pkts_round"):
        np.testing.assert_array_equal(
            getattr(got, f)(pt.net, pt.topo),
            getattr(want, f)(pj.net, pj.topo))


def test_schedule_constants_and_names_match_jax():
    assert (tschedule.HierarchicalSchedule.PHASE_ORDER
            == jschedule.HierarchicalSchedule.PHASE_ORDER)
    assert (tschedule.HierarchicalSchedule.PRIORITY
            == jschedule.HierarchicalSchedule.PRIORITY)
    assert sorted(tschedule.SCHEDULES) == sorted(jschedule.SCHEDULES)
    with pytest.raises(ValueError, match="unknown collective schedule"):
        tschedule.get_schedule("torus")
    assert (ttopology.STREAM_DCI_FABRIC, ttopology.STREAM_DCI_CNP) == (
        jtopology.STREAM_DCI_FABRIC, jtopology.STREAM_DCI_CNP)


@pytest.mark.parametrize("oversub", [4.0, (2.0, 4.0, 8.0, 1.5)])
def test_overlay_rates_equal_the_numpy_in_place_overlay(oversub):
    """The column-vector overlay on numpy arrays equals the JAX package's
    in-place one bit for bit: the device core applies this formula."""
    kw = dict(dci_oversubscription=oversub)
    pj = _hier(jparams, jtopology, 4, "ring", **kw)
    pt = _hier(tparams, ttopology, 4, "ring", **kw)
    rng = np.random.default_rng(0)
    jhg = jtopology.hier_geometry(pj.net, pj.topo)
    thg = ttopology.hier_geometry(pt.net, pt.topo)
    occ32 = rng.random((50, 32)).astype(np.float32)
    occ_eff = rng.random((50, thg.cross.size))
    rate = rng.random((50, 32)).astype(np.float32)
    qd = jengine.network.queue_delay_us(pj.net, occ32)
    eff = rate * jengine.network.avail_bandwidth(pj.net, occ32)
    j_occ = occ32.copy()
    jtopology.overlay_rates(pj.net, pj.topo, jhg, occ_eff, rate, j_occ, qd,
                            eff)
    cols = ttopology.dci_columns(pt.topo, thg)
    t_occ = occ32.copy()
    t_occ[:, thg.cross] = occ_eff.astype(np.float32)
    got_qd, got_eff = ttopology.overlay_rates(pt.net, t_occ, rate,
                                              cols.oversub)
    np.testing.assert_array_equal(t_occ, j_occ)
    np.testing.assert_array_equal(got_qd, qd)
    np.testing.assert_array_equal(got_eff, eff)
    t = rng.random((50, 32)).astype(np.float32)
    want_t = t.copy()
    jtopology.add_dci_latency(pj.topo, jhg, want_t)
    np.testing.assert_array_equal(t + cols.dci_add, want_t)
    assert ttopology.dci_columns(
        pt.topo, dataclasses.replace(thg, cross=thg.cross[:0])) is None


def test_hier_params_matches_jax():
    kw = dict(n_nodes=64, dci_oversubscription=(2.0, 8.0), schedule="perrail",
              fault="stall:0.001+flap:0.0005", dci_rtt_us=20.0)
    want = jtopology.hier_params(2, **kw)
    got = ttopology.hier_params(2, **kw)
    for f in ("net", "topo", "work", "fault"):
        assert (dataclasses.asdict(getattr(got, f))
                == dataclasses.asdict(getattr(want, f))), f


def test_hier_protocol_needs_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttopology.hier_protocol(ttopology.hier_params(2, base=_small(
            tparams)), 2)
