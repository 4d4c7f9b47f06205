"""The port's flow plans (``schedule.flow_plan``, ``with_step_priorities``)
and the engine's ``plan=`` override with the incast overlay, against the
JAX package's numpy engine on the CPU.

Tolerances are the engine's contract (``tests/test_torch_engine.py``):
the same host draws, so delivered packets per step, per tier and per pod
are exact; rtol 1e-5 on step times, round times, p99 and delivered
fractions.  A fan-in-1 plan draws nothing new, so the explicit ring as a
plan is bit-identical to the port's engine without a plan.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.transport import engine as jengine
from repro.core.transport import params as jparams
from repro.core.transport import schedule as jschedule
from repro.serve import traffic as jtraffic
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import engine_torch
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport import schedule as tschedule
from repro_torch.serve import traffic as ttraffic

RTOL = 1e-5
DESIGNS = ("roce", "irn", "srnic", "celeris")
ROUNDS = 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(mod, n_pods=1):
    """tests/test_schedule.py's SMALL fabric from ``mod``'s params, on
    ``n_pods`` pods."""
    p = mod.SimParams(net=mod.NetworkParams(n_nodes=32,
                                            burst_on_prob=0.0008))
    return dataclasses.replace(p, topo=dataclasses.replace(p.topo,
                                                           n_pods=n_pods))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=0, err_msg=what)


# ------------------------------------------------------------ validation

def _phase(mod, src, dst, **kw):
    kw = {"n_steps": 2, "payload_bytes": 1 << 10, **kw}
    return mod.SchedulePhase(name="x", src=np.asarray(src),
                             dst=np.asarray(dst), **kw)


# tests/test_flowplan.py's invalid phases, and a negative priority class
INVALID = {
    "length": ([[0, 1], [2]], {}),
    "sender": ([[0, 0], [1, 2]], {}),
    "self": ([[0, 1], [0, 2]], {}),
    "payload": ([[0], [1]], {"payload_bytes": 0}),
    "priority": ([[0], [1]], {"priority": -1}),
}


@pytest.mark.parametrize("what", sorted(INVALID) + ["non-empty"])
def test_flow_plan_validation_errors_match(what):
    def build(mod):
        if what == "non-empty":
            return mod.flow_plan("bad", ())
        (src, dst), kw = INVALID[what]
        return mod.flow_plan("bad", (_phase(mod, src, dst, **kw),))

    with pytest.raises(Exception) as want:
        build(jschedule)
    with pytest.raises(type(want.value), match=what):
        build(tschedule)


def test_flow_plan_drops_empty_phases():
    for mod in (jschedule, tschedule):
        ph = _phase(mod, [0], [1])
        empty = mod.SchedulePhase(name="idle", src=np.array([], int),
                                  dst=np.array([], int), n_steps=0,
                                  payload_bytes=1 << 10)
        plan = mod.flow_plan("p", (empty, ph))
        assert plan.phase_names == ("x",) and plan.steps_per_round == 2


def _mixed(mod):
    """Idle nodes and fan-in 1, 2 and 3: 32 nodes, three phases."""
    return mod.flow_plan("mixed", (
        mod.SchedulePhase(name="gather", src=np.array([0, 1, 2, 3, 4, 5, 6]),
                          dst=np.array([8, 8, 9, 9, 9, 10, 24]), n_steps=3,
                          payload_bytes=1 << 16, priority=1),
        mod.SchedulePhase(name="idle", src=np.array([], int),
                          dst=np.array([], int), n_steps=0,
                          payload_bytes=1),
        mod.SchedulePhase(name="spread", src=np.array([8, 9, 10, 16, 17]),
                          dst=np.array([20, 21, 22, 24, 24]), n_steps=2,
                          payload_bytes=3 << 14),
        mod.SchedulePhase(name="p2p", src=np.array([24]),
                          dst=np.array([0]), n_steps=1,
                          payload_bytes=1 << 12, budget_frac=2.0)))


def _explicit_ring(mod, n, message_bytes):
    src = np.arange(n)
    return mod.flow_plan("ring_explicit", (mod.SchedulePhase(
        name="ring", src=src, dst=(src + 1) % n, n_steps=2 * (n - 1),
        payload_bytes=message_bytes // n),))


def _kv(mod, traffic):
    return traffic.kv_flow_plan(traffic.ServeTrafficParams(n_prefill=28,
                                                           n_decode=4))


PLANS = {"kv": lambda mod, traffic: _kv(mod, traffic),
         "mixed": lambda mod, traffic: _mixed(mod),
         "ring": lambda mod, traffic: _explicit_ring(mod, 32, 25 << 20)}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_members_match(name):
    got = PLANS[name](tschedule, ttraffic)
    want = PLANS[name](jschedule, jtraffic)
    assert got.schedule == want.schedule
    assert got.phase_names == want.phase_names
    assert got.steps_per_round == want.steps_per_round
    np.testing.assert_array_equal(got.phase_of_step, want.phase_of_step)
    np.testing.assert_array_equal(got.step_priority(), want.step_priority())
    assert got.max_fan_in() == want.max_fan_in()
    assert got.bytes_per_round() == want.bytes_per_round()
    np.testing.assert_array_equal(got.budget_fracs(), want.budget_fracs())
    for a, b in zip(got.phases, want.phases):
        np.testing.assert_array_equal(a.fan_in(), b.fan_in())
    net = tparams.NetworkParams(n_nodes=32)
    for pods in (1, 2):
        topo = tparams.TopologyParams(n_pods=pods)
        jnet = jparams.NetworkParams(n_nodes=32)
        jtopo = jparams.TopologyParams(n_pods=pods)
        np.testing.assert_array_equal(got.tier_pkts_round(net, topo),
                                      want.tier_pkts_round(jnet, jtopo))
        np.testing.assert_array_equal(got.pod_pkts_round(net, topo),
                                      want.pod_pkts_round(jnet, jtopo))


def test_with_step_priorities_matches():
    for mod in (jschedule, tschedule):
        plan = _mixed(mod)
        cls = np.array([2, 0, 1, 1, 0, 3])
        out = mod.with_step_priorities(plan, cls)
        np.testing.assert_array_equal(out.step_priority(), cls)
        assert out.phases is plan.phases
        for bad, match in ((cls[:-1], "shape"), (-cls, ">= 0")):
            with pytest.raises(ValueError, match=match):
                mod.with_step_priorities(plan, bad)
    got = tschedule.with_step_priorities(_mixed(tschedule), [1, 1, 0, 0, 2, 0])
    want = jschedule.with_step_priorities(_mixed(jschedule),
                                          [1, 1, 0, 0, 2, 0])
    np.testing.assert_array_equal(got.priority_of_step,
                                  want.priority_of_step)
    np.testing.assert_array_equal(got.step_priority(), want.step_priority())


# ---------------------------------------------------------------- engine

def _engines(name, n_pods=1):
    tplan, jplan = PLANS[name](tschedule, ttraffic), PLANS[name](jschedule,
                                                                 jtraffic)
    if name == "kv":
        tp = ttraffic.ServeTrafficParams(n_prefill=28, n_decode=4)
        tnet = dataclasses.replace(ttraffic.serve_net_params(tp),
                                   burst_on_prob=0.0008)
        jnet = dataclasses.replace(jtraffic.serve_net_params(
            jtraffic.ServeTrafficParams(n_prefill=28, n_decode=4)),
            burst_on_prob=0.0008)
        tp_, jp_ = tparams.SimParams(net=tnet), jparams.SimParams(net=jnet)
    else:
        tp_, jp_ = _small(tparams, n_pods), _small(jparams, n_pods)
    return (tengine.BatchedEngine(tp_, device="cpu", plan=tplan),
            jengine.BatchedEngine(jp_, plan=jplan))


CASES = [("kv", 1), ("mixed", 1), ("mixed", 2), ("ring", 1)]


@pytest.fixture(scope="module")
def plan_traces():
    out = {}
    for name, pods in CASES:
        teng, jeng = _engines(name, pods)
        out[(name, pods)] = (
            teng, teng.traces(list(DESIGNS), ROUNDS, 3, legacy_streams=False),
            jeng, jeng.traces(list(DESIGNS), ROUNDS, 3, legacy_streams=False))
    return out


@pytest.mark.parametrize("name,pods", CASES)
def test_plan_traces_match_numpy_engine(plan_traces, name, pods):
    _, got, _, want = plan_traces[(name, pods)]
    for d in DESIGNS:
        g, w = got[d], want[d]
        for f in ("deliv", "total", "tier_deliv", "tier_total", "pod_deliv",
                  "pod_total"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), (d, f)
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{d} {f}")
        _close(g.nat_us, w.nat_us, f"{d} nat_us")
        np.testing.assert_array_equal(g.step_priority, w.step_priority)
    if name != "ring":
        # the incast columns lose packets somewhere in these plans
        assert (want["celeris"].deliv < want["celeris"].total).any()


@pytest.mark.parametrize("window", ["round", "phase"])
@pytest.mark.parametrize("name,pods", CASES)
def test_plan_assembly_matches_numpy_engine(plan_traces, name, pods, window):
    teng, got, jeng, want = plan_traces[(name, pods)]
    for d in DESIGNS:
        kw = {}
        if d == "celeris":
            nat = want[d].nat_us.reshape(ROUNDS, -1).sum(1)
            kw = {"celeris_timeout_us": float(np.median(nat)) * 0.9,
                  "adaptive": False, "window": window}
        g, w = teng.assemble(got[d], 3, **kw), jeng.assemble(want[d], 3, **kw)
        for f in ("times_us", "recv_frac", "tier_recv_frac", "pod_recv_frac",
                  "prio_recv_frac"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), (d, f)
            if b is not None:
                _close(a, b, f"{d} {f}")
        _close(g.p99, w.p99, f"{d} p99")
        np.testing.assert_array_equal(g.prio_pkts, w.prio_pkts)


def test_kv_plan_takes_the_sender_subset_route():
    """28 senders of 32 nodes: the core gathers the phase's sender
    columns (index_select), not the all-senders fast path; the incast
    stream exists only for a plan with fan-in > 1."""
    teng, _ = _engines("kv")
    ctx = engine_torch._Plan(teng)
    s = ctx.phases[0]
    assert ctx.single and not s["all_senders"] and ctx.incast
    assert s["inc"].size == 28 and set(s["fan"][s["inc"]]) == {7}
    assert s["fan_t"].dtype == torch.float32
    st = engine_torch._SeedStreams(teng, 0, ["celeris"], ctx.incast)
    assert hasattr(st, "inc_cnp_gen")
    ring, _ = _engines("ring")
    rctx = engine_torch._Plan(ring)
    assert rctx.phases[0]["all_senders"] and not rctx.incast
    assert rctx.phases[0]["fan_t"] is None
    assert not hasattr(engine_torch._SeedStreams(ring, 0, ["celeris"],
                                                 rctx.incast), "inc_cnp_gen")


def test_fan_in_one_plan_is_bit_identical_to_no_plan(plan_traces):
    """The ring rebuilt from raw flows draws nothing new: its traces equal
    the port's no-plan engine bit for bit."""
    _, got, _, _ = plan_traces[("ring", 1)]
    base = tengine.BatchedEngine(_small(tparams), device="cpu").traces(
        list(DESIGNS), ROUNDS, 3, legacy_streams=False)
    for d in DESIGNS:
        for f in ("nat_us", "deliv", "total", "tier_deliv", "tier_total"):
            np.testing.assert_array_equal(getattr(got[d], f),
                                          getattr(base[d], f), err_msg=d)


def test_plan_refuses_legacy_streams():
    teng, jeng = _engines("kv")
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="FlowPlan override"):
            eng.traces(["roce"], 2, 0, legacy_streams=True)
    # run() sends a plan to the shared fabric, as the numpy engine does
    got = teng.run("roce", 4, seed=1)
    want = jeng.run("roce", 4, seed=1)
    _close(got.times_us, want.times_us, "run roce times")
