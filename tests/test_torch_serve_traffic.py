"""The port's serving traffic (``repro_torch.serve.traffic``) against the
JAX package's, and Fig. 8's smoke protocol on the port's CPU engine.

``traffic`` is numpy on the host in both packages: on the same inputs the
request process, the FIFO queue's outcomes and the loss attribution must
be equal exactly (tolerance: none).  The smoke Fig. 8 protocol (28
prefill -> 4 decode, 120 rounds, loads 0.6 / 0.9) through the port's
engine with the KV incast plan must give the 19 engine-derived
``smoke_fig8_*`` keys of ``BENCH_sim.json`` at their printed digits; the
three recovery keys come from the smoke LM under torch's generators and
are held to their bar on the card (``chip_smoke.phase_fig8``).  The
protocol functions are ``repro_torch.benchmarks.figs``'s, which the card
runs at the full tier.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core.transport import telemetry as jtelemetry
from repro.serve import traffic as jt
from repro_torch.benchmarks import figs
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport import telemetry as ttelemetry
from repro_torch.serve import traffic as tt

BENCH = os.path.join(os.path.dirname(__file__), os.pardir, "BENCH_sim.json")
TPS = [dict(n_prefill=28, n_decode=4), dict(n_prefill=112, n_decode=16),
       dict(n_prefill=30, n_decode=4, steps_per_round=5, load=1.2)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_and_params_match():
    for name in ("STREAM_ARRIVALS", "STREAM_LENGTHS", "STREAM_KV_HOLES"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert ttelemetry.CAUSES == jtelemetry.CAUSES
    assert (dataclasses.asdict(tt.ServeTrafficParams())
            == dataclasses.asdict(jt.ServeTrafficParams()))


@pytest.mark.parametrize("kw", TPS)
def test_params_plan_and_net_match(kw):
    a, b = tt.ServeTrafficParams(**kw), jt.ServeTrafficParams(**kw)
    for f in ("n_nodes", "fan_in", "capacity_blocks_per_round",
              "mean_request_blocks"):
        assert getattr(a, f) == getattr(b, f), f
    assert (dataclasses.asdict(tt.serve_net_params(a))
            == dataclasses.asdict(jt.serve_net_params(b)))
    pa, pb = tt.kv_flow_plan(a), jt.kv_flow_plan(b)
    (pha,), (phb,) = pa.phases, pb.phases
    np.testing.assert_array_equal(pha.src, phb.src)
    np.testing.assert_array_equal(pha.dst, phb.dst)
    np.testing.assert_array_equal(pa.step_priority(), pb.step_priority())
    assert pa.max_fan_in() == pb.max_fan_in() == a.fan_in
    assert pa.bytes_per_round() == pb.bytes_per_round()
    for ref in (1e3, 5.5e4):
        assert (tt.arrival_rate_per_us(a, ref)
                == jt.arrival_rate_per_us(b, ref))
    assert (tt.nominal_round_us(a, tt.serve_net_params(a))
            == jt.nominal_round_us(b, jt.serve_net_params(b)))


def _rounds(seed, R, loss_causes):
    rng = np.random.default_rng(seed)
    times = rng.uniform(2e4, 9e4, R)
    frac = np.where(rng.random(R) < 0.3, rng.uniform(0.8, 1.0, R), 1.0)
    lr = rng.uniform(0.0, 0.05, (max(R // 3, 1), loss_causes))
    return times, frac, lr


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kw", TPS)
def test_request_trace_and_queue_match(kw, seed):
    a, b = tt.ServeTrafficParams(**kw), jt.ServeTrafficParams(**kw)
    times, frac, lr = _rounds(seed, 150, len(jtelemetry.CAUSES))
    horizon, ref = float(times.sum()), 5.5e4
    ta = tt.request_trace(a, horizon, ref, seed)
    tb = jt.request_trace(b, horizon, ref, seed)
    assert ta.n_requests == tb.n_requests > 10
    for f in ("arrival_us", "ready_us", "kv_blocks", "decode_tokens"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f), f)
    for rates in (None, lr):
        ra = tt.simulate_serving(a, times, frac, ta, loss_rates=rates)
        rb = jt.simulate_serving(b, times, frac, tb, loss_rates=rates)
        for f in ("latency_us", "completed", "kv_frac", "kv_loss_by_cause"):
            x, y = getattr(ra, f), getattr(rb, f)
            assert (x is None) == (y is None), f
            if y is not None:
                np.testing.assert_array_equal(x, y, f)
        assert ra.blocks_shipped == rb.blocks_shipped
        for f in ("p99_latency_us", "completion_frac", "mean_kv_frac"):
            assert getattr(ra, f) == getattr(rb, f), f
        assert ra.loss_attribution() == rb.loss_attribution()


def test_smoke_fig8_protocol_gives_committed_keys():
    tp = tt.ServeTrafficParams(**figs.FIG8_SMOKE_TP)
    stats, budget, eng = figs.fig8_engine_rounds(tp, figs.FIG8_SMOKE_ROUNDS,
                                                 0, "cpu")
    assert eng.timing["blocks"] == 1
    keys, f_cell = figs.fig8_keys(tp, figs.FIG8_SMOKE_LOADS, stats, budget,
                                  0, "smoke_fig8")
    with open(BENCH) as f:
        bench = json.load(f)
    want = {k: v for k, v in bench.items() if k.startswith("smoke_fig8_")
            and "recovery" not in k and "token_agree" not in k}
    assert len(want) == 19
    assert keys == want
    assert f_cell == keys["smoke_fig8_kv_frac_tail_celeris_hiload"]


def test_engine_needs_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal cannot be observed")
    tp = tt.ServeTrafficParams()
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.BatchedEngine(tparams.SimParams(net=tt.serve_net_params(tp)),
                              plan=tt.kv_flow_plan(tp))


def test_fig8_recovery_cell_on_cpu():
    """fig8's recovery cell (the smoke LM decoding from caches degraded at
    the committed tail fraction 0.95) on the CPU's plain versions: the
    coded cache keeps the bar's usable context, the uncoded one loses
    whole positions."""
    out, (clean, mask, signs) = figs.fig8_recovery("cpu", 0.95, 0)
    assert out["wire_rows_lost"] == int((mask == 0).sum()) > 0
    assert mask.shape == signs.shape == (figs.FIG8_N_ROT,)
    assert clean.leaves()[0].dtype == clean.leaves()[1].dtype
    assert out["coded"]["usable"] >= figs.FIG8_RECOVERY_BAR
    assert out["coded"]["usable"] > out["uncoded"]["usable"]
    assert 0.0 <= out["coded"]["token_agree"] <= 1.0


def test_kv_wire_check_on_recovery_inputs():
    """chip_smoke's check of the coded KV transfer's kernels, on the
    recovery cell's own caches, mask and signs, with the plain versions
    standing in for the kernels behind the wrappers' argument checks (on
    the card it holds the kernels to them): both payloads' encode,
    unbias and decode shapes, error 0."""
    import types

    import chip_smoke
    from repro_torch.core import coding
    from repro_torch.kernels import ref
    def fwht_cuda(x, signs, scale):       # the wrapper's argument checks
        assert x.dtype == torch.float32 and x.dim() == 2
        assert x.is_contiguous()
        assert signs is None or (signs.dtype == torch.float32
                                 and signs.shape == (x.shape[1],))
        return ref.fwht(x, signs=signs, scale=scale)

    def masked_unbias_cuda(y, counts, total):
        assert y.dtype == torch.float32 and y.dim() == 2
        assert y.is_contiguous() and counts.is_contiguous()
        assert counts.dtype == torch.float32
        assert counts.shape == (y.shape[0],)
        return ref.masked_unbias(y, counts, total)

    _, wire = figs.fig8_recovery("cpu", 0.95, 0)
    kfwht = types.SimpleNamespace(fwht_cuda=fwht_cuda)
    kunbias = types.SimpleNamespace(masked_unbias_cuda=masked_unbias_cuda)
    out = chip_smoke.check_kv_wire("cpu", *wire, kfwht, kunbias, ref, coding)
    assert out["max_abs_err"] == {"fwht": 0.0, "masked_unbias": 0.0}
    nb = coding.plan(wire[0].leaves()[0].numel(),
                     n_rot=figs.FIG8_N_ROT).n_blocks
    assert out["shapes"] == [f"fwht [{nb}, {figs.FIG8_N_ROT}]",
                             f"masked_unbias [{figs.FIG8_N_ROT}, {nb}]"]
