"""The port's legacy-stream engine mode against the JAX package's numpy
engine, on the CPU: ``replay.py``, ``network.roce_fabric_trace``, the
legacy ``traces``/``run``/``paper_protocol``/``sweep`` and
``CollectiveSimulator``.

The stream replays consume numpy generators in the numpy engine's order,
so their outputs are equal bit for bit.  The engine is held to the
numpy engine's ``legacy_streams=True`` as the shared-fabric mode is
(``tests/test_torch_engine.py``): delivered packets and tier sums exact,
rtol 1e-5 on times, p99 and delivered fractions.  The DCQCN scan on the
stacked channels is held at that file's tolerances (float32 rates rtol
1e-6, float64 state rtol 1e-12, ``good`` exact) and, on these inputs,
bit for bit.
"""
import dataclasses

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:                     # container lacks hypothesis
    from _propcheck import hypothesis, st
import numpy as np
import pytest
import torch

from repro.core.transport import coupling as jcoupling
from repro.core.transport import dcqcn as jdcqcn
from repro.core.transport import engine as jengine
from repro.core.transport import network as jnetwork
from repro.core.transport import params as jparams
from repro.core.transport import replay as jreplay
from repro.core.transport import topology as jtopology
from repro.core.transport.simulator import (
    CollectiveSimulator as JSimulator)
from repro_torch.core.transport import coupling as tcoupling
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import network as tnetwork
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport import replay as treplay
from repro_torch.core.transport import topology as ttopology
from repro_torch.core.transport.simulator import (
    CollectiveSimulator as TSimulator)
from repro_torch.kernels import ref

RTOL = 1e-5
ROUNDS = 20
DESIGNS = ("roce", "irn", "srnic", "celeris")
DESIGN_SETS = (DESIGNS, ("roce",), ("irn",), ("srnic", "celeris"),
               ("celeris",))


def _small(mod, **net):
    """tests/test_schedule.py's SMALL fabric (32 nodes), from ``mod``'s
    params (the JAX package's or the port's)."""
    return mod.SimParams(net=mod.NetworkParams(
        n_nodes=32, **dict({"burst_on_prob": 0.0008}, **net)))


def _engines(**net):
    return (jengine.BatchedEngine(_small(jparams, **net)),
            tengine.BatchedEngine(_small(tparams, **net), device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain scan's ops are tiny: intra-op threads only add overhead,
    and under parallel test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)


def _check_traces(got, want):
    assert set(got) == set(want)
    for d, w in want.items():
        g = got[d]
        for f in ("deliv", "total", "tier_deliv", "tier_total"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f"{d} {f}")
        _close(g.nat_us, w.nat_us, f"{d} step times")


def _check_stats(got, want, what):
    _close(got.times_us, want.times_us, f"{what} times")
    _close(got.p99, want.p99, f"{what} p99")
    _close(got.recv_frac, want.recv_frac, f"{what} recv_frac")
    _close(got.tier_recv_frac, want.tier_recv_frac, f"{what} tier frac")


# ------------------------------------------------------------ replay.py

@hypothesis.given(st.integers(0, 2**31 - 1))
@hypothesis.settings(max_examples=8, deadline=None)
def test_binomial_inversion_matches_reference(seed):
    rng = np.random.default_rng(seed)
    m = 400
    U = rng.random(m)
    p = rng.uniform(0, 0.05, m)
    n = rng.integers(1, 200, m)
    np.testing.assert_array_equal(treplay.binomial_inversion(U, n, p),
                                  jreplay.binomial_inversion(U, n, p))


def test_binomial_inversion_refuses_bound_restart():
    """A uniform past the bound's mass would make numpy draw again: the
    replay raises instead of drifting out of sync, as the reference."""
    U, p = np.array([np.nextafter(1.0, 0.0)]), np.array([0.01])
    for mod in (treplay, jreplay):
        with pytest.raises(RuntimeError, match="bound restart"):
            mod.binomial_inversion(U, 50, p)


def _drop_ecn(seed, T=300, n=16):
    """Sparse hot steps, as the fabric gives them (the reference's own
    replay test's inputs)."""
    rng = np.random.default_rng(seed)
    drop_p = np.zeros((T, n))
    hot = rng.integers(0, T, 40)
    drop_p[hot] = rng.uniform(0, 0.025, (hot.size, n)) * (
        rng.random((hot.size, n)) < 0.5)
    ecn = np.clip(drop_p * 20 + rng.uniform(-0.5, 0.02, (T, n)), 0, 1)
    return drop_p, ecn


@hypothesis.given(st.integers(0, 2**31 - 1))
@hypothesis.settings(max_examples=6, deadline=None)
def test_replays_match_reference(seed):
    drop_p, ecn = _drop_ecn(seed)
    for fn in ("replay_selective_repeat", "replay_celeris"):
        got = getattr(treplay, fn)(seed, 50, drop_p, ecn)
        want = getattr(jreplay, fn)(seed, 50, drop_p, ecn)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f"{fn} {f.name}")
        assert want.k.any() and want.cnp.any()


# ------------------------------------------------- roce_fabric_trace

@pytest.mark.parametrize("window", [4, 64])
@pytest.mark.parametrize("seed", [0, 7])
def test_roce_fabric_trace_matches_reference(seed, window):
    """A high burst rate, so PFC cascades survive their first draw and the
    replay re-anchors the stream (PCG64.advance) many times."""
    kw = dict(n_nodes=32, burst_on_prob=0.05)
    src = np.arange(32)
    dst = (src + 1) % 32
    got = tnetwork.roce_fabric_trace(tparams.NetworkParams(**kw), seed, src,
                                     dst, 900, window=window)
    want = jnetwork.roce_fabric_trace(jparams.NetworkParams(**kw), seed,
                                      src, dst, 900, window=window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pause = tparams.NetworkParams().pfc_pause_us
    assert (want[1] > pause).sum() > 10          # cascades re-anchored


# ------------------------------------------------- the DCQCN channels

def _channels(seed, C=3, T=1500, n=12):
    rng = np.random.default_rng(seed)
    prob = np.zeros((C, T, 1))
    for c in range(C):
        for s0 in rng.integers(0, T - 40, 8):
            prob[c, s0:s0 + 30] = 0.1
    return rng.random((C, T, n)) < prob


def _stacked_scan(cnp, any_t):
    C, _, n = cnp.shape
    state = (torch.ones(C, n, dtype=torch.float64),
             torch.ones(C, n, dtype=torch.float64),
             torch.ones(C, n, dtype=torch.float64),
             torch.zeros(C, n, dtype=torch.int32))
    return ref.dcqcn_scan(cnp, any_t, *state, tparams.DcqcnParams())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stacked_scan_matches_rate_trace(seed):
    """The legacy pass's scan: channels as the seed axis, the step mask
    the OR over every channel and flow (rate_trace materializes every
    flow of every channel there).  Equal to rate_trace on the
    (T, C, n) stack within test_torch_engine's tolerances, and here bit
    for bit; a per-channel mask rounds the calm ramps apart."""
    cnp = _channels(seed)
    C, T, _ = cnp.shape
    want, wst = jdcqcn.rate_trace(np.stack(list(cnp), axis=1),
                                  jparams.DcqcnParams(), dtype=np.float32)
    want = np.moveaxis(want, 1, 0)
    c = torch.from_numpy(cnp)
    rates, (r, t, a, g) = _stacked_scan(
        c, c.any(-1).any(0).expand(C, T).contiguous())
    np.testing.assert_allclose(rates.numpy(), want, rtol=1e-6, atol=0)
    for x, w in ((r, wst.rate), (t, wst.target), (a, wst.alpha)):
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(g.numpy(), wst.good_stages)
    np.testing.assert_array_equal(rates.numpy(), want)
    per_channel, _ = _stacked_scan(c, c.any(-1))
    assert not np.array_equal(per_channel.numpy(), want)


def test_legacy_pass_scans_with_the_shared_step_mask(monkeypatch):
    """The engine's one scan call: channels roce, sr, celeris, the mask
    the OR over all of them, and the rates rate_trace gives the stack."""
    from repro_torch.core.transport import engine_torch
    seen = []

    def scan(cnp, any_t, *state):
        seen.append((cnp.clone(), any_t.clone()))
        return ref.dcqcn_scan(cnp, any_t, *state)

    monkeypatch.setattr(engine_torch, "ops", type(
        "Ops", (), {"dcqcn_scan": staticmethod(scan)}))
    _, teng = _engines(burst_on_prob=0.003)
    teng.traces(list(DESIGNS), ROUNDS, 0)
    ((cnp, any_t),) = seen
    C, T, _ = cnp.shape
    assert C == 3
    assert torch.equal(any_t, cnp.any(-1).any(0).expand(C, T))
    assert not torch.equal(any_t, cnp.any(-1))     # the channels differ
    want, _ = jdcqcn.rate_trace(np.stack(list(cnp.numpy()), axis=1),
                                jparams.DcqcnParams(), dtype=np.float32)
    got, _ = _stacked_scan(cnp, any_t)
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(want, 1, 0))


# ------------------------------------------------------------- engine

@pytest.mark.parametrize("design_set", DESIGN_SETS,
                         ids=["+".join(d) for d in DESIGN_SETS])
@pytest.mark.parametrize("seed", [0, 3])
def test_legacy_traces_match_numpy_engine(seed, design_set):
    """Each design set draws its own channels (and so its own step mask):
    delivered packets and tier sums exact, step times within rtol 1e-5;
    one scan call over the whole trace."""
    jeng, teng = _engines()
    want = jeng.traces(list(design_set), ROUNDS, seed, legacy_streams=True)
    got = teng.traces(list(design_set), ROUNDS, seed)
    _check_traces(got, want)
    assert teng.timing["blocks"] == 1
    if "celeris" in design_set:
        assert (want["celeris"].deliv < want["celeris"].total).any()


def test_legacy_differs_from_shared_mode():
    """The two stream modes are different physics, on both sides."""
    jeng, teng = _engines()
    got = teng.traces(["irn"], ROUNDS, 0)["irn"].nat_us
    shared = teng.traces(["irn"], ROUNDS, 0,
                         legacy_streams=False)["irn"].nat_us
    want = jeng.traces(["irn"], ROUNDS, 0)["irn"].nat_us
    _close(got, want, "legacy irn")
    assert not np.allclose(got, shared, rtol=RTOL)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("design", DESIGNS)
def test_legacy_run_matches_numpy_engine(design, adaptive):
    """run's defaults and flip rules: legacy streams, except adaptive
    Celeris (shared fabric on both sides)."""
    jeng, teng = _engines()
    kw = dict(seed=4, adaptive=adaptive, window="round",
              celeris_timeout_us=9_000.0)
    _check_stats(teng.run(design, ROUNDS, **kw),
                 jeng.run(design, ROUNDS, **kw), f"{design} {adaptive}")


FLIPS = {
    "hier schedule": lambda mod, topo: dataclasses.replace(
        _small(mod), work=mod.WorkloadParams(schedule="hier")),
    "stall fault": lambda mod, topo: dataclasses.replace(
        _small(mod), fault=mod.FaultParams.parse("stall:1e-3")),
}


@pytest.mark.parametrize("what", sorted(FLIPS))
def test_run_flips_to_shared_mode_like_numpy(what):
    """A non-ring schedule or an active fault has no sequential stream:
    run goes to the shared-fabric mode, on both sides."""
    jeng = jengine.BatchedEngine(FLIPS[what](jparams, jtopology))
    teng = tengine.BatchedEngine(FLIPS[what](tparams, ttopology),
                                 device="cpu")
    _check_stats(teng.run("irn", 8, seed=1), jeng.run("irn", 8, seed=1),
                 what)


@pytest.mark.parametrize("seed", [0, 3])
def test_legacy_paper_protocol_matches_numpy_engine(seed):
    jeng, teng = _engines()
    want = jeng.paper_protocol(ROUNDS, seed)
    got = teng.paper_protocol(ROUNDS, seed)
    for d, w in want.items():
        _check_stats(got[d], w, d)
    assert want["celeris"].recv_frac.min() < 1.0       # the window binds


def test_collective_simulator_matches_numpy():
    jsim = JSimulator(_small(jparams))
    tsim = TSimulator(_small(tparams), device="cpu")
    for d, w in jsim.paper_protocol(ROUNDS, 1).items():
        _check_stats(tsim.paper_protocol(ROUNDS, 1)[d], w, d)
    kw = dict(adaptive=False, celeris_timeout_us=8_000.0, seed=2)
    _check_stats(tsim.run("celeris", ROUNDS, **kw),
                 jsim.run("celeris", ROUNDS, **kw), "run celeris")


def test_collective_simulator_needs_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSimulator(_small(tparams))


def test_legacy_sweep_matches_numpy():
    """sweep(legacy_streams=True): each seed's legacy pass, every design
    and window assembled from it, as the numpy sweep does."""
    kw = dict(n_nodes=(32,), seeds=(0, 5), windows=("round", "phase"),
              n_rounds=10, legacy_streams=True, timeout_scale=0.7)
    want = jengine.sweep(jengine.BatchedSimParams(base=_small(jparams), **kw))
    got = tengine.sweep(tengine.BatchedSimParams(base=_small(tparams), **kw),
                        device="cpu")
    assert set(got.stats) == set(want.stats)
    for key, w in want.stats.items():
        _check_stats(got.stats[key], w, str(key))
    (timing,) = got.timing.values()
    assert timing["seeds"] == 2 and timing["blocks"] == 2


def test_schedule_from_engine_legacy_matches_numpy():
    kw = dict(seed=2, timeout_scale=0.6, legacy_streams=True)
    got = tcoupling.schedule_from_engine(ROUNDS, params=_small(tparams),
                                         device="cpu", **kw)
    want = jcoupling.schedule_from_engine(ROUNDS, params=_small(jparams),
                                          **kw)
    _close(got.rates, want.rates, "drop rates")
    assert want.rates.any()


# ------------------------------------------------------------- guards

GUARDS = {
    "multi-pod": (lambda mod, topo: topo.hier_params(2, base=_small(mod)),
                  "n_pods > 1"),
    "hier schedule": (FLIPS["hier schedule"], "schedule='hier'"),
    "active fault": (FLIPS["stall fault"], "fault injection"),
}


@pytest.mark.parametrize("what", sorted(GUARDS))
def test_legacy_guards_raise_like_numpy(what):
    """Legacy streams where the sequential simulator never ran raise the
    reference's ValueError, word for word, from traces and
    paper_protocol (and from run on the multi-pod ring, which run does
    not flip)."""
    make, match = GUARDS[what]
    jeng = jengine.BatchedEngine(make(jparams, jtopology))
    teng = tengine.BatchedEngine(make(tparams, ttopology), device="cpu")
    calls = [lambda e: e.traces(["roce"], 2, 0),
             lambda e: e.paper_protocol(2, 0)]
    if what == "multi-pod":
        calls.append(lambda e: e.run("roce", 2))
    for call in calls:
        msgs = []
        for eng in (jeng, teng):
            with pytest.raises(ValueError, match=match) as err:
                call(eng)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
