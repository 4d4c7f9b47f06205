"""The port's transport engine (``repro_torch.core.transport``) against the
numpy engine of the JAX package, on the CPU.

The JAX package's device backend (``engine_jax``) does not run on the
installed jax, so the reference is the numpy ``BatchedEngine`` in its
shared-fabric mode (``legacy_streams=False``) and the pinned
``tests/data/ring_schedule_seed_stats.json["flat"]``, which is in that
mode.  Tolerances (``engine_jax``'s contract):

- DCQCN scan, plain version against ``dcqcn.rate_trace`` on the same
  CNP arrays: float32 rates rtol 1e-6, float64 state rtol 1e-12,
  ``good`` exact (torch's CPU ``pow`` may differ from C's by an ulp);
- engine: the same host draws, so delivered packets per step are exact;
  rtol 1e-5 on times, p99 and delivered fractions.  It is not exact:
  torch takes ``occ ** 3`` as two multiplies where numpy calls ``powf``,
  and the excess time is ``A + B * pkt_time`` where numpy sums episode
  by episode, so about 0.1 % of step times differ by a float32 ulp.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.transport import dcqcn as jdcqcn
from repro.core.transport import engine as jengine
from repro.core.transport import network as jnetwork
from repro.core.transport import params as jparams
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import engine_torch
from repro_torch.core.transport import network as tnetwork
from repro_torch.core.transport import params as tparams
from repro_torch.kernels import dcqcn as kdcqcn
from repro_torch.kernels import ops, ref

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-5
DENSITIES = (0.0, 0.001, 0.05, 1.0)


def _small(mod):
    """tests/test_schedule.py's SMALL fabric, built from ``mod``'s
    params (the JAX package's or the port's)."""
    return mod.SimParams(net=mod.NetworkParams(n_nodes=32,
                                               burst_on_prob=0.0008))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The scan's ops are tiny: intra-op threads only add overhead, and
    under parallel test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- DCQCN

def _state(S, n):
    return (torch.ones(S, n, dtype=torch.float64),
            torch.ones(S, n, dtype=torch.float64),
            torch.ones(S, n, dtype=torch.float64),
            torch.zeros(S, n, dtype=torch.int32))


def _scan(cnp, state):
    c = torch.from_numpy(cnp)
    return ref.dcqcn_scan(c, c.any(-1), *state, tparams.DcqcnParams())


def _check_block(rates, state, want_rates, want_state, s):
    np.testing.assert_allclose(rates[s].numpy(), want_rates, rtol=1e-6,
                               atol=0)
    r, t, a, g = (x[s].numpy() for x in state)
    np.testing.assert_allclose(r, want_state.rate, rtol=1e-12, atol=0)
    np.testing.assert_allclose(t, want_state.target, rtol=1e-12, atol=0)
    np.testing.assert_allclose(a, want_state.alpha, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(g, want_state.good_stages)


@pytest.mark.parametrize("density", DENSITIES)
def test_dcqcn_scan_matches_rate_trace(density):
    """Two seeds batched: each equals its own rate_trace; density 0 is an
    all-calm block, 1.0 marks every step."""
    rng = np.random.default_rng(7)
    cnp = rng.random((2, 600, 24)) < density
    cnp[1, ::37] |= rng.random((cnp[1, ::37].shape)) < 0.2  # seeds differ
    rates, state = _scan(cnp, _state(2, 24))
    for s in range(2):
        want, st = jdcqcn.rate_trace(cnp[s], jparams.DcqcnParams(),
                                     dtype=np.float32)
        _check_block(rates, state, want, st, s)


@pytest.mark.parametrize("split", [1, 233, 599])
def test_dcqcn_scan_carries_state_across_blocks(split):
    """Two blocks with the state carried equal rate_trace run in the same
    two blocks, whatever the split."""
    rng = np.random.default_rng(split)
    cnp = rng.random((1, 600, 16)) < 0.01
    r1, st1 = _scan(cnp[:, :split], _state(1, 16))
    r2, st2 = _scan(cnp[:, split:], st1)
    w1, js = jdcqcn.rate_trace(cnp[0, :split], jparams.DcqcnParams(),
                               dtype=np.float32)
    w2, js = jdcqcn.rate_trace(cnp[0, split:], jparams.DcqcnParams(), js,
                               dtype=np.float32)
    _check_block(torch.cat([r1, r2], 1), st2, np.concatenate([w1, w2]), js, 0)


def test_dcqcn_dispatch_and_cuda_wrapper_guard():
    """ops sends a CPU tensor to the plain version (no launch); the CUDA
    wrapper refuses a CPU tensor instead of computing on it."""
    cnp = np.random.default_rng(0).random((1, 50, 8)) < 0.05
    c = torch.from_numpy(cnp)
    before = kdcqcn.launches
    got = ops.dcqcn_scan(c, c.any(-1), *_state(1, 8), tparams.DcqcnParams())
    want = ref.dcqcn_scan(c, c.any(-1), *_state(1, 8), tparams.DcqcnParams())
    assert torch.equal(got[0], want[0])
    assert kdcqcn.launches == before
    with pytest.raises(ValueError):
        kdcqcn.dcqcn_scan_cuda(c, c.any(-1), *_state(1, 8),
                               tparams.DcqcnParams())


def test_response_curves_on_tensors_match_numpy():
    net_j, net_t = jparams.NetworkParams(), tparams.NetworkParams()
    occ = np.random.default_rng(1).random((64, 32)).astype(np.float32)
    occ_t = torch.from_numpy(occ)
    np.testing.assert_array_equal(
        tnetwork.avail_bandwidth(net_t, occ_t).numpy(),
        jnetwork.avail_bandwidth(net_j, occ))
    np.testing.assert_allclose(
        tnetwork.queue_delay_us(net_t, occ_t).numpy(),
        jnetwork.queue_delay_us(net_j, occ), rtol=1e-6)
    for f in ("ecn_mark_prob", "drop_prob"):
        np.testing.assert_array_equal(getattr(tnetwork, f)(net_t, occ),
                                      getattr(jnetwork, f)(net_j, occ))


# ---------------------------------------------------------------- engine

def _engines(params_j=None, params_t=None):
    return (jengine.BatchedEngine(params_j or _small(jparams)),
            tengine.BatchedEngine(params_t or _small(tparams), device="cpu"))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=0, err_msg=what)


def _check_traces(got, want):
    for d, w in want.items():
        g = got[d]
        np.testing.assert_array_equal(g.deliv, w.deliv, err_msg=d)
        np.testing.assert_array_equal(g.total, w.total, err_msg=d)
        np.testing.assert_array_equal(g.tier_deliv, w.tier_deliv, err_msg=d)
        np.testing.assert_array_equal(g.tier_total, w.tier_total, err_msg=d)
        _close(g.nat_us, w.nat_us, f"{d} nat_us")


def test_flat_ring_reproduces_pinned_seed_stats():
    """The pinned shared-fabric flat ring (seed 11, 40 rounds, window
    scale 0.8), within rtol 1e-5.  Not bit for bit: the step times carry
    the float32 ulps of the module docstring, and the pinned window is
    the RoCE times' median + std, so it moves by ~1e-9 relative."""
    ref_stats = json.load(open(os.path.join(
        DATA, "ring_schedule_seed_stats.json")))["flat"]
    _, eng = _engines()
    tr = eng.traces(["roce", "celeris"], 40, seed=11,
                    legacy_streams=False)
    base = eng.assemble(tr["roce"], 11)
    _close(base.times_us, ref_stats["roce_times_us"], "roce times")
    to = float(np.percentile(base.times_us, 50) + base.times_us.std()) * 0.8
    _close(to, ref_stats["celeris_timeout_us"], "celeris window")
    cel = eng.assemble(tr["celeris"], 11, celeris_timeout_us=to,
                       adaptive=False, window="round")
    _close(cel.times_us, ref_stats["celeris_times_us"], "celeris times")
    _close(cel.recv_frac, ref_stats["celeris_recv_frac"], "celeris recv")


@pytest.mark.parametrize("seed", [0, 3])
def test_paper_protocol_matches_numpy_engine(seed):
    """All four designs: per-step delivered packets exact; times, p99,
    recv_frac and tier_recv_frac within rtol 1e-5."""
    jeng, teng = _engines()
    want_tr = jeng.traces(jengine.designs.DESIGNS, 30, seed,
                          legacy_streams=False)
    got_tr = teng.traces(tengine.designs.DESIGNS, 30, seed,
                         legacy_streams=False)
    _check_traces(got_tr, want_tr)
    want = jeng.paper_protocol(30, seed, legacy_streams=False)
    got = teng.paper_protocol(30, seed, legacy_streams=False)
    for d, w in want.items():
        g = got[d]
        _close(g.times_us, w.times_us, f"{d} times")
        _close(g.p99, w.p99, f"{d} p99")
        _close(g.recv_frac, w.recv_frac, f"{d} recv_frac")
        _close(g.tier_recv_frac, w.tier_recv_frac, f"{d} tier_recv_frac")
        np.testing.assert_array_equal(g.tier_counts, w.tier_counts)
        np.testing.assert_array_equal(g.tier_pkts, w.tier_pkts)
        _close(g.prio_recv_frac, w.prio_recv_frac, f"{d} prio_recv_frac")


def test_traces_batched_equals_single_seed_numpy_runs():
    """Seeds (0, 1, 2) in one batched pass (one scan a block over the
    three seeds) equal three single-seed numpy runs; the block partition
    is the numpy engine's, set small here so the state crosses blocks."""
    jeng, teng = _engines()
    got = engine_torch.traces_batched(teng, ["roce", "irn", "celeris"], 12,
                                      [0, 1, 2], round_block=5)
    assert teng.timing["blocks"] == 3 and teng.timing["seeds"] == 3
    for si, seed in enumerate((0, 1, 2)):
        want = jeng.traces(["roce", "irn", "celeris"], 12, seed,
                           legacy_streams=False, round_block=5)
        _check_traces(got[si], want)


@pytest.fixture(scope="module")
def celeris_traces():
    jeng, teng = _engines()
    return (jeng, jeng.traces(["celeris"], 40, 2, legacy_streams=False),
            teng, teng.traces(["celeris"], 40, 2, legacy_streams=False))


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("window", ["round", "phase"])
@pytest.mark.parametrize("timeout_us", [1500.0, 3000.0])
def test_assemble_matches_numpy(celeris_traces, adaptive, window,
                                timeout_us):
    """The round windows, fixed and adaptive (the controller's own
    seeded noise stream), on the same traces' celeris column; "phase"
    on the single-phase ring is the round window."""
    jeng, jtr, teng, ttr = celeris_traces
    kw = dict(celeris_timeout_us=timeout_us, adaptive=adaptive,
              window=window)
    want = jeng.assemble(jtr["celeris"], 2, **kw)
    got = teng.assemble(ttr["celeris"], 2, **kw)
    assert want.recv_frac.min() < 1.0          # the window binds
    _close(got.times_us, want.times_us, "times")
    _close(got.recv_frac, want.recv_frac, "recv_frac")
    _close(got.tier_recv_frac, want.tier_recv_frac, "tier_recv_frac")


def test_engine_needs_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.BatchedEngine(_small(tparams))
