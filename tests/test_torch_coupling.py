"""The port's transport-to-trainer coupling against the JAX package's, on
the CPU: drop schedules from the engine, and the trainer walking them.

The JAX side's engine is the numpy ``BatchedEngine``; the port's runs its
device core on the CPU with the plain DCQCN scan.  Schedule rates are
held to rtol 1e-5 (the engine's tolerance contract, see
``tests/test_torch_engine.py``) and to the same ``source`` tag.
"""
import numpy as np
import pytest
import torch

from benchmarks import fig1_e2e_loss_tolerance as fig1
from repro.core.transport import coupling as jcoupling
from repro.core.transport import engine as jengine
from repro_torch import configs as TC
from repro_torch.core.transport import coupling as tcoupling
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import params as tparams
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

SMOKE_T = tparams.SimParams(net=tparams.NetworkParams(n_nodes=32,
                                                      burst_on_prob=0.0008))
SMOKE_ROUNDS = 14        # fig1_e2e_loss_tolerance's smoke run, --steps 14


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rates", [[0.7, -0.1, 0.2], [0.0], [0.5, 0.49]])
def test_drop_schedule_clamps_and_wraps_like_jax(rates):
    got = tcoupling.DropSchedule(rates=rates)
    want = jcoupling.DropSchedule(rates=rates)
    np.testing.assert_array_equal(got.rates, want.rates)
    assert got.rates.max() <= tcoupling.MAX_DROP == jcoupling.MAX_DROP
    assert [got.rate(i) for i in range(7)] == [want.rate(i) for i in range(7)]
    assert (got.mean, got.p99) == (want.mean, want.p99)
    with pytest.raises(ValueError):
        tcoupling.DropSchedule(rates=[])


@pytest.mark.parametrize("scale,adaptive", [(0.8, False), (0.4, False),
                                            (0.8, True)])
def test_schedule_from_engine_matches_jax(scale, adaptive):
    """fig1_e2e_loss_tolerance's smoke fabric (32 nodes, 14 rounds); 0.8 is
    its paper regime, 0.4 a heavier one, and the adaptive window runs the
    controller's seeded noise stream."""
    want = jcoupling.schedule_from_engine(
        SMOKE_ROUNDS, seed=0, params=fig1.SMOKE_PARAMS, timeout_scale=scale,
        adaptive=adaptive)
    got = tcoupling.schedule_from_engine(
        SMOKE_ROUNDS, seed=0, params=SMOKE_T, timeout_scale=scale,
        adaptive=adaptive, device="cpu")
    assert got.source == want.source
    assert want.rates.max() > 0            # the window binds somewhere
    np.testing.assert_allclose(got.rates, want.rates, rtol=1e-5, atol=1e-12)
    assert got.provenance.source == want.provenance.source == "heuristic"
    np.testing.assert_allclose(got.provenance.rates, want.provenance.rates,
                               rtol=1e-5, atol=1e-12)
    assert got.provenance.describe().split(":")[0] == \
        want.provenance.describe().split(":")[0]


def test_schedule_from_round_stats_matches_jax():
    """The same RoundStats arrays give the same schedule and provenance."""
    jeng = jengine.BatchedEngine(fig1.SMOKE_PARAMS)
    tr = jeng.traces(["celeris"], 10, 4, legacy_streams=False)
    st = jeng.assemble(tr["celeris"], 4, celeris_timeout_us=2000.0,
                       adaptive=False)
    tst = tengine.RoundStats(
        times_us=st.times_us, recv_frac=st.recv_frac, design=st.design,
        tier_recv_frac=st.tier_recv_frac, tier_counts=st.tier_counts,
        tier_pkts=st.tier_pkts)
    want = jcoupling.schedule_from_round_stats(st)
    got = tcoupling.schedule_from_round_stats(tst)
    np.testing.assert_array_equal(got.rates, want.rates)
    assert got.source == want.source
    np.testing.assert_array_equal(got.provenance.rates, want.provenance.rates)
    assert got.provenance.tiers == want.provenance.tiers


def test_lossless_design_gives_zero_schedule():
    s = tcoupling.schedule_from_engine(4, seed=1, params=SMOKE_T,
                                       design="irn", device="cpu")
    assert s.rates.shape == (4,) and not s.rates.any()
    assert s.source.startswith("engine:irn n=32 seed=1")


def test_record_and_legacy_streams_raise():
    for kw in ({"record": True}, {"legacy_streams": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcoupling.schedule_from_engine(2, params=SMOKE_T, device="cpu",
                                           **kw)


def test_schedule_from_engine_needs_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcoupling.schedule_from_engine(2, params=SMOKE_T)


def test_engine_straggler_model_walks_the_schedule_in_order():
    sched = tcoupling.DropSchedule(rates=[0.1, 0.2, 0.3], source="t")
    got, want = (m(s) for m, s in (
        (tcoupling.EngineStragglerModel, sched),
        (jcoupling.EngineStragglerModel, jcoupling.DropSchedule(
            rates=[0.1, 0.2, 0.3]))))
    rng = np.random.default_rng(0)
    seq = [got.drop_rate(1.0, rng) for _ in range(5)]
    assert seq == [want.drop_rate(1.0, rng) for _ in range(5)]
    assert seq == [0.1, 0.2, 0.3, 0.1, 0.2]
    assert got.steps_taken == 5 and got.median_latency == 1.0


def test_trainer_walks_an_engine_schedule():
    """Three lossy_hadamard steps of the smoke LM driven by an engine
    schedule: the trainer's drop rates are the schedule's first three."""
    sched = tcoupling.schedule_from_engine(
        SMOKE_ROUNDS, seed=0, params=SMOKE_T, timeout_scale=0.4,
        device="cpu")
    cfg = TC.get_smoke("qwen2-0.5b")
    tr = ttrainer.Trainer(
        cfg, data_cfg=tpipe.DataConfig(cfg.vocab_size, 32, 4, seed=1),
        opt_cfg=tadamw.OptConfig(lr=1e-3, warmup_steps=10, total_steps=500),
        celeris=tts.CelerisConfig(mode="lossy_hadamard", min_coded_size=1024),
        straggler=tcoupling.EngineStragglerModel(sched), device="cpu")
    hist = tr.run(3)
    assert hist["drop_rate"] == list(sched.rates[:3])
    assert np.isfinite(hist["loss"]).all()
    assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"])
