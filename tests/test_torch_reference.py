"""The port's sequential reference loop and its host pieces against the
JAX package, on the CPU: ``designs.transfer``, ``network.ClosFabric``,
the host ``dcqcn.step``, ``dcqcn.rate_trace`` (the DCQCN scan's plain
version here), ``reference.SequentialCollectiveSimulator`` and Fig. 2's
sequential keys (``figs.fig2_sequential``).

Every input is made from a seed with numpy, and both packages get
generators with the same seed.  The host code is the same numpy
operations in the same order, so everything is compared bit for bit:
results, ``parts`` dicts, and the generators' states after each call.
The port's legacy ``BatchedEngine`` is held to the port's loop as
``tests/test_batched_engine.py`` holds the numpy engine to JAX's loop,
at its tolerances.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core.transport import dcqcn as jdcqcn
from repro.core.transport import designs as jdesigns
from repro.core.transport import network as jnetwork
from repro.core.transport import params as jparams
from repro.core.transport.reference import (
    SequentialCollectiveSimulator as JSeq)
from repro_torch.benchmarks import figs
from repro_torch.core.transport import dcqcn as tdcqcn
from repro_torch.core.transport import designs as tdesigns
from repro_torch.core.transport import network as tnetwork
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport.engine import BatchedEngine
from repro_torch.core.transport.reference import (
    SequentialCollectiveSimulator as TSeq)
from repro_torch.core.transport.simulator import CollectiveSimulator

DESIGNS = ("roce", "irn", "srnic", "celeris")
SEQ_STATS = os.path.join(os.path.dirname(__file__), "data",
                         "paper_protocol_seed_stats.json")


def _small(mod):
    """``tests/test_batched_engine.py``'s SMALL, from ``mod``'s params."""
    return mod.SimParams(net=mod.NetworkParams(n_nodes=32,
                                               burst_on_prob=0.0008))


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, np.ascontiguousarray(a).tobytes()


def _same(a, b, what=""):
    assert _bits(a) == _bits(b), what


def _same_rng(a: np.random.Generator, b: np.random.Generator):
    assert a.bit_generator.state == b.bit_generator.state


# ------------------------------------------------------------- transfer

def _transfer_inputs(shape, seed, strided):
    """One block's per-flow inputs on the 128-node fabric's curves: a
    burst-like occupancy (about a third of the entries past the loss
    knee), its drop and queue curves, a rate and PFC pauses.  ``strided``
    hands in transposed (non-C-contiguous) views."""
    net = jparams.NetworkParams()
    rng = np.random.default_rng(seed)
    full = shape[::-1] if strided else shape
    occ = np.where(rng.random(full) < 0.35, rng.uniform(0.8, 0.99, full),
                   rng.uniform(0.05, 0.5, full))
    rate = rng.uniform(0.2, 1.0, full)
    pfc = np.where(rng.random(full) < 0.1, net.pfc_pause_us, 0.0)
    if strided:
        occ, rate, pfc = occ.T, rate.T, pfc.T
    return (net, occ, rate, jnetwork.drop_prob(net, occ), pfc,
            jnetwork.queue_delay_us(net, occ))


@pytest.mark.parametrize("shape", [(128,), (6, 32), "strided"])
@pytest.mark.parametrize("design", DESIGNS)
def test_transfer_matches_jax(design, shape):
    """Times, delivered and total packets and the ``parts`` dict, bit for
    bit, and the generators' states after the call; a call without
    ``parts`` gives the same results."""
    strided = shape == "strided"
    net, occ, rate, drop, pfc, qd = _transfer_inputs(
        (32, 6) if strided else shape, 7, strided)
    rel = jparams.ReliabilityParams()
    n_pkts = 512
    got_parts, want_parts = {}, {}
    gj, gt = np.random.default_rng(11), np.random.default_rng(11)
    want = jdesigns.transfer(design, n_pkts, occ, rate, drop, pfc, qd, rel,
                             net, gj, parts=want_parts)
    got = tdesigns.transfer(design, n_pkts, occ, rate, drop, pfc, qd,
                            tparams.ReliabilityParams(),
                            tparams.NetworkParams(), gt, parts=got_parts)
    _same_rng(gt, gj)
    for f in ("time_us", "delivered_pkts", "total_pkts"):
        _same(getattr(got, f), getattr(want, f), f)
    assert sorted(got_parts) == sorted(want_parts)
    for k in want_parts:
        _same(got_parts[k], want_parts[k], k)
    assert (drop > 0).any() and (drop == 0).any()
    again = tdesigns.transfer(design, n_pkts, occ, rate, drop, pfc, qd,
                              tparams.ReliabilityParams(),
                              tparams.NetworkParams(),
                              np.random.default_rng(11))
    _same(again.time_us, want.time_us)


@pytest.mark.parametrize("design", DESIGNS)
def test_transfer_below_the_knee_draws_nothing(design):
    """No entry is drop-capable: nothing is drawn, on either side."""
    net = jparams.NetworkParams()
    occ = np.full(64, 0.3)
    args = (occ, np.ones(64), jnetwork.drop_prob(net, occ), np.zeros(64),
            jnetwork.queue_delay_us(net, occ))
    gj, gt = np.random.default_rng(2), np.random.default_rng(2)
    want = jdesigns.transfer(design, 64, *args, jparams.ReliabilityParams(),
                             net, gj)
    got = tdesigns.transfer(design, 64, *args, tparams.ReliabilityParams(),
                            tparams.NetworkParams(), gt)
    _same_rng(gt, gj)
    _same_rng(gt, np.random.default_rng(2))
    _same(got.time_us, want.time_us)
    _same(got.delivered_pkts, want.delivered_pkts)


# ----------------------------------------------------------- ClosFabric

@pytest.mark.parametrize("nodes_per_tor", [8, 32])
def test_clos_fabric_matches_jax(nodes_per_tor):
    """50 ticks of the burst process, then at each tick the path
    occupancy, the response curves and the PFC cascade (its own draws on
    the fabric's generator), bit for bit, with the generators' states
    equal after; a bursty fabric, so that pauses cascade."""
    kw = dict(n_nodes=64, nodes_per_tor=nodes_per_tor, burst_on_prob=0.2,
              burst_off_prob=0.1)
    jf = jnetwork.ClosFabric(jparams.NetworkParams(**kw), seed=5)
    tf = tnetwork.ClosFabric(tparams.NetworkParams(**kw), seed=5)
    src = np.arange(64)
    dst = (src + 1) % 64
    assert tf.n_tors == jf.n_tors == 64 // nodes_per_tor
    _same(tf.tor_of(src), jf.tor_of(src))
    paused = 0
    for _ in range(50):
        jf.advance()
        tf.advance()
        _same(tf.state.bursting, jf.state.bursting)
        _same(tf.state.occupancy, jf.state.occupancy)
        occ = tf.path_occupancy(src, dst)
        _same(occ, jf.path_occupancy(src, dst))
        for f in ("queue_delay_us", "avail_bandwidth", "ecn_mark_prob",
                  "drop_prob", "pfc_pause_us"):
            _same(getattr(tf, f)(occ), getattr(jf, f)(occ), f)
        paused += int((jf.pfc_pause_us(occ) > 0).sum())
        tf.pfc_pause_us(occ)
        _same_rng(tf.rng, jf.rng)
    assert paused > 0


# ---------------------------------------------------------- DCQCN step

@pytest.mark.parametrize("shape", [(128,), (3, 40)])
def test_host_step_matches_jax_and_torch(shape):
    """The host ``step`` against JAX's ``step`` and against the torch
    ``step_math`` on the CPU, bit for bit, over 40 steps from random
    states with random marks."""
    rng = np.random.default_rng(3)
    p = tparams.DcqcnParams()
    r = rng.uniform(0.01, 1.0, shape)
    t = np.maximum(r, rng.uniform(0.01, 1.0, shape))
    a = rng.uniform(0.0, 1.0, shape)
    g = rng.integers(0, 12, shape)
    host = tdcqcn.HostDcqcnState(r, t, a, g)
    jst = jdcqcn.DcqcnState(r, t, a, g)
    tt = [torch.as_tensor(x) for x in (r, t, a)] + [
        torch.as_tensor(g, dtype=torch.int32)]
    for i in range(40):
        cnp = rng.random(shape) < (0.02 if i % 10 else 0.5)
        host = tdcqcn.step(host, cnp, p)
        jst = jdcqcn.step(jst, cnp, jparams.DcqcnParams())
        tt = tdcqcn.step_math(*tt, torch.as_tensor(cnp), p)
        for f, x in zip(("rate", "target", "alpha"), tt):
            _same(getattr(host, f), getattr(jst, f), f)
            _same(getattr(host, f), x.numpy(), f)
        _same(host.good_stages, jst.good_stages)
        np.testing.assert_array_equal(host.good_stages, tt[3].numpy())
    assert (host.good_stages > p.hyper_after).any()


def test_host_state_init_is_jax():
    for f in ("rate", "target", "alpha", "good_stages"):
        _same(getattr(tdcqcn.HostDcqcnState.init(7), f),
              getattr(jdcqcn.DcqcnState.init(7), f), f)


# ----------------------------------------------------------- rate_trace

@pytest.mark.parametrize("start", ["init", "mid"])
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
def test_rate_trace_matches_jax(density, start):
    """``rate_trace`` on a (T, 2, 16) trace through the scan's plain
    version against JAX's ``rate_trace(dtype=np.float32)``: the float32
    rates and the final float64 state bit for bit, from the initial
    state and from a state in mid-recovery."""
    rng = np.random.default_rng(int(density * 100) + 1)
    cnp = rng.random((300, 2, 16)) < density
    jp, p = jparams.DcqcnParams(), tparams.DcqcnParams()
    jst, tst = None, None
    if start == "mid":
        shape = (2, 16)
        r = rng.uniform(0.05, 0.9, shape)
        jst = jdcqcn.DcqcnState(r, np.minimum(1.0, r + 0.1),
                                rng.uniform(0.0, 1.0, shape),
                                rng.integers(0, 10, shape).astype(np.int32))
        tst = tdcqcn.DcqcnState(*(torch.as_tensor(getattr(jst, f)) for f in
                                  ("rate", "target", "alpha",
                                   "good_stages")))
    want, wst = jdcqcn.rate_trace(cnp, jp, jst, dtype=np.float32)
    got, gst = tdcqcn.rate_trace(torch.as_tensor(cnp), p, tst)
    assert got.dtype == torch.float32 and got.shape == cnp.shape
    _same(got.numpy(), want)
    for f in ("rate", "target", "alpha"):
        _same(getattr(gst, f).numpy(), getattr(wst, f), f)
    np.testing.assert_array_equal(gst.good_stages.numpy(), wst.good_stages)
    assert gst.good_stages.dtype == torch.int32


# --------------------------------------------------- the sequential loop

SEQ_RUNS = {
    "roce": ("roce", {}),
    "irn": ("irn", {}),
    "srnic": ("srnic", {}),
    "celeris_round_adaptive": ("celeris", {}),
    "celeris_round_fixed": ("celeris", {"celeris_timeout_us": 20_000.0,
                                        "adaptive": False}),
    "celeris_step_adaptive": ("celeris", {"window": "step"}),
    "celeris_step_fixed": ("celeris", {"celeris_timeout_us": 15_000.0,
                                       "adaptive": False, "window": "step"}),
}


@pytest.mark.parametrize("seed", [3, None])
@pytest.mark.parametrize("case", list(SEQ_RUNS))
def test_sequential_run_matches_jax(case, seed):
    """``run`` at SMALL (32 nodes) against JAX's loop, 40 rounds: times
    and delivered fractions bit for bit; ``seed=None`` takes the params'
    seed."""
    design, kw = SEQ_RUNS[case]
    want = JSeq(_small(jparams)).run(design, 40, seed=seed, **kw)
    got = TSeq(_small(tparams)).run(design, 40, seed=seed, **kw)
    assert got.design == want.design == design
    np.testing.assert_array_equal(got.times_us, want.times_us)
    np.testing.assert_array_equal(got.recv_frac, want.recv_frac)
    if design == "celeris":
        assert got.mean_loss > 0


def test_sequential_seed_none_is_the_params_seed():
    p = dataclasses.replace(_small(tparams), seed=3)
    a = TSeq(p).run("irn", 20)
    b = TSeq(_small(tparams)).run("irn", 20, seed=3)
    np.testing.assert_array_equal(a.times_us, b.times_us)


# ----------------------- the port's engine against the port's loop
# (tests/test_batched_engine.py:34-66, at its tolerances)

def test_selective_repeat_matches_sequential_exactly():
    for design in ("irn", "srnic"):
        seq = TSeq(_small(tparams)).run(design, 60, seed=3)
        bat = BatchedEngine(_small(tparams), device="cpu").run(
            design, 60, seed=3)
        np.testing.assert_allclose(bat.times_us, seq.times_us, rtol=2e-5)
        np.testing.assert_array_equal(bat.recv_frac, seq.recv_frac)


def test_celeris_fixed_window_matches_sequential_exactly():
    kw = dict(celeris_timeout_us=20_000.0, adaptive=False, window="round",
              seed=4)
    seq = TSeq(_small(tparams)).run("celeris", 60, **kw)
    bat = BatchedEngine(_small(tparams), device="cpu").run("celeris", 60,
                                                           **kw)
    np.testing.assert_allclose(bat.times_us, seq.times_us, rtol=2e-5)
    np.testing.assert_allclose(bat.recv_frac, seq.recv_frac, atol=1e-6)


def test_roce_matches_sequential_statistically():
    seq = TSeq(_small(tparams)).run("roce", 120, seed=5)
    bat = BatchedEngine(_small(tparams), device="cpu").run("roce", 120,
                                                           seed=5)
    assert abs(bat.p50 / seq.p50 - 1) < 0.01
    assert abs(bat.p99 / seq.p99 - 1) < 0.15
    idle = seq.times_us == np.median(seq.times_us)
    np.testing.assert_allclose(bat.times_us[idle], seq.times_us[idle],
                               rtol=2e-5)


# ------------------------------------------------- Fig. 2's sequential keys

@pytest.fixture(scope="module")
def smoke_fig2():
    """The smoke tier (benchmarks/run.py:147-151): the engine's paper
    protocol, then the sequential protocol in child processes."""
    params = figs.smoke_params()
    stats = CollectiveSimulator(params, device="cpu").paper_protocol(
        figs.FIG2_SMOKE_ROUNDS, 0)
    return figs.fig2_sequential(params, figs.FIG2_SMOKE_ROUNDS, 0, 1.0,
                                stats["roce"].p99, prefix="smoke_fig2")


def test_smoke_fig2_sequential_keys(smoke_fig2):
    """``smoke_fig2_ab_p99_ratio_roce`` is the committed 1.102; the wall
    key is the sum of the four runs' seconds, the speedup that sum over
    the engine's wall; no kernel launched."""
    keys, stats, seconds, launches = smoke_fig2
    assert keys["smoke_fig2_ab_p99_ratio_roce"] == 1.102
    assert set(stats) == set(seconds) == set(DESIGNS)
    assert all(s > 0 for s in seconds.values())
    wall = sum(seconds.values())
    assert keys["smoke_fig2_sequential_wall_s"] == round(wall, 2)
    assert keys["smoke_fig2_engine_speedup_x"] == round(wall / 1.0, 1)
    assert set(launches) == {"fwht", "fwht_quantize", "masked_unbias",
                             "quantize_int8", "dcqcn_scan"}
    assert not any(launches.values()), launches


def test_fig2_sequential_is_the_serial_protocol(smoke_fig2):
    """The child processes' runs are the script's serial protocol: each
    design from this process's loop, Celeris at the RoCE run's p50 + std
    with the fixed round window."""
    _, stats, _, _ = smoke_fig2
    seq = TSeq(figs.smoke_params())
    base = seq.run("roce", figs.FIG2_SMOKE_ROUNDS, seed=0)
    to = float(np.percentile(base.times_us, 50) + base.times_us.std())
    want = {"roce": base,
            **{d: seq.run(d, figs.FIG2_SMOKE_ROUNDS, seed=0)
               for d in ("irn", "srnic")},
            "celeris": seq.run("celeris", figs.FIG2_SMOKE_ROUNDS,
                               celeris_timeout_us=to, adaptive=False,
                               window="round", seed=0)}
    for d in DESIGNS:
        np.testing.assert_array_equal(stats[d].times_us, want[d].times_us)
        np.testing.assert_array_equal(stats[d].recv_frac, want[d].recv_frac)


def test_recorded_stats_file_has_every_design():
    """The recorded pre-refactor statistics that ``chip_smoke.py`` holds
    the loop to at 128 nodes x 300 rounds name every design and stat."""
    with open(SEQ_STATS) as f:
        seq = json.load(f)
    for d in DESIGNS:
        assert set(seq[d]) == {"p50_us", "p99_us", "p999_us", "mean_us",
                               "data_loss"}

