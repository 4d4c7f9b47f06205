"""The port's transport-to-trainer coupling against the JAX package's, on
the CPU: drop schedules from the engine, and the trainer walking them.

The JAX side's engine is the numpy ``BatchedEngine``; the port's runs its
device core on the CPU with the plain DCQCN scan.  Schedule rates are
held to rtol 1e-5 (the engine's tolerance contract, see
``tests/test_torch_engine.py``) and to the same ``source`` tag.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from benchmarks import fig1_e2e_loss_tolerance as fig1
from benchmarks import fig4_cross_pod_tail as fig4
from repro.core import coding as jcoding
from repro.core.transport import coupling as jcoupling
from repro.core.transport import engine as jengine
from repro.core.transport import params as jparams
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.data import pipeline as jpipe
from repro.train import train_step as jts
from repro_torch import configs as TC
from repro_torch.core.transport import coupling as tcoupling
from repro_torch.models import convert
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import params as tparams
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer
from test_torch_dp_train import fake_world

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
    """``record=True`` gives the flight recorder's provenance (in the
    shared-fabric mode, even when legacy streams are asked for, as the
    numpy engine decides), equal to the JAX package's; legacy streams
    raise where the numpy engine refuses them too (a multi-pod fabric)."""
    jsmoke = jparams.SimParams(net=jparams.NetworkParams(
        n_nodes=32, burst_on_prob=0.0008))
    for legacy in (False, True):
        got = tcoupling.schedule_from_engine(
            6, params=SMOKE_T, device="cpu", record=True,
            legacy_streams=legacy, timeout_scale=0.6)
        want = jcoupling.schedule_from_engine(
            6, params=jsmoke, record=True, legacy_streams=legacy,
            timeout_scale=0.6)
        assert got.provenance.source == want.provenance.source == "recorded"
        assert got.provenance.phases == want.provenance.phases
        np.testing.assert_allclose(got.rates, want.rates, rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(got.provenance.rates,
                                   want.provenance.rates, rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(
            np.clip(got.provenance.total(), 0.0, tcoupling.MAX_DROP),
            got.rates, atol=1e-9)
    pods = dataclasses.replace(SMOKE_T, topo=tparams.TopologyParams(
        n_pods=2))
    jpods = jparams.SimParams(net=jparams.NetworkParams(n_nodes=32),
                              topo=jparams.TopologyParams(n_pods=2))
    for fn, p, kw in ((tcoupling.schedule_from_engine, pods,
                       {"device": "cpu"}),
                      (jcoupling.schedule_from_engine, jpods, {})):
        with pytest.raises(ValueError, match="n_pods > 1"):
            fn(2, params=p, legacy_streams=True, **kw)


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


# ------------------------------------------------ hierarchical coupling

def _check_schedule(got, want):
    assert got.source == want.source
    np.testing.assert_allclose(got.rates, want.rates, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("schedule,window,fault", [
    (None, "round", None), ("hier", "phase", None),
    (None, "round", "stall:0.003"), ("perrail", "round", "rail:0.3")])
def test_split_schedule_from_engine_matches_jax(schedule, window, fault):
    """fig4's smoke fabric (32 nodes, 2 pods): intra, cross and per-pod
    schedules, their sources and provenance, against the JAX package's."""
    kw = dict(n_pods=2, schedule=schedule, window=window, fault=fault,
              timeout_scale=0.6)
    want = jcoupling.split_schedule_from_engine(
        SMOKE_ROUNDS, seed=1, params=fig4.SMOKE_PARAMS, **kw)
    got = tcoupling.split_schedule_from_engine(
        SMOKE_ROUNDS, seed=1, params=SMOKE_T, device="cpu", **kw)
    assert got.source == want.source
    _check_schedule(got.intra, want.intra)
    _check_schedule(got.cross, want.cross)
    assert got.n_pods == want.n_pods == 2
    for a, b in zip(got.per_pod, want.per_pod):
        _check_schedule(a, b)
    for a, b in ((got.intra, want.intra), (got.cross, want.cross)):
        assert a.provenance.tiers == b.provenance.tiers
        np.testing.assert_allclose(a.provenance.rates, b.provenance.rates,
                                   rtol=1e-5, atol=1e-12)
    assert max(want.cross.rates.max(), want.intra.rates.max()) > 0
    for step in range(SMOKE_ROUNDS + 2):
        np.testing.assert_allclose(got.rates(step), want.rates(step),
                                   rtol=1e-5, atol=1e-12)


def test_split_schedule_from_round_stats_matches_jax():
    """The same RoundStats arrays give the same split; without per-pod
    fractions the vector is (2,) [intra, cross]."""
    p = dataclasses.replace(fig4.SMOKE_PARAMS, topo=jparams.TopologyParams(
        n_pods=2))
    jeng = jengine.BatchedEngine(p)
    tr = jeng.traces(["celeris"], 10, 4, legacy_streams=False)
    st = jeng.assemble(tr["celeris"], 4, celeris_timeout_us=1500.0,
                       adaptive=False)
    for pods in (True, False):
        kw = dict(times_us=st.times_us, recv_frac=st.recv_frac,
                  design=st.design, tier_recv_frac=st.tier_recv_frac,
                  tier_counts=st.tier_counts, tier_pkts=st.tier_pkts,
                  pod_recv_frac=st.pod_recv_frac if pods else None,
                  pod_pkts=st.pod_pkts if pods else None)
        want = jcoupling.split_schedule_from_round_stats(
            jengine.RoundStats(**kw))
        got = tcoupling.split_schedule_from_round_stats(
            tengine.RoundStats(**kw))
        np.testing.assert_array_equal(got.intra.rates, want.intra.rates)
        np.testing.assert_array_equal(got.cross.rates, want.cross.rates)
        assert got.rates(3).shape == ((3,) if pods else (2,))
        np.testing.assert_array_equal(got.rates(3), want.rates(3))
        assert got.mean == want.mean
    with pytest.raises(ValueError, match="per-tier"):
        tcoupling.split_schedule_from_round_stats(tengine.RoundStats(
            times_us=st.times_us, recv_frac=st.recv_frac, design="celeris"))


def test_hier_straggler_model_walks_the_axis_schedule():
    rates = np.array([[0.1, 0.2, 0.3], [0.0, 0.05, 0.6]])
    sched = {m: m.AxisSchedules(
        intra=m.DropSchedule(rates=rates[0]),
        cross=m.DropSchedule(rates=rates[1]),
        per_pod=(m.DropSchedule(rates=rates[0] / 2),
                 m.DropSchedule(rates=rates[0] * 2)))
        for m in (tcoupling, jcoupling)}
    got = tcoupling.HierStragglerModel(sched[tcoupling])
    want = jcoupling.HierStragglerModel(sched[jcoupling])
    rng = np.random.default_rng(0)
    seq = [got.drop_rate(1.0, rng) for _ in range(5)]
    for a in seq:
        assert a.shape == (3,)
    for a, b in zip(seq, [want.drop_rate(1.0, rng) for _ in range(5)]):
        np.testing.assert_array_equal(a, b)
    assert got.schedules is sched[tcoupling] and got.steps_taken == 5


def test_split_schedule_refusals():
    """``record=True`` gives each axis the recorder's provenance, equal
    to the JAX package's; without CUDA the default device is refused."""
    got = tcoupling.split_schedule_from_engine(6, params=SMOKE_T, record=True,
                                               device="cpu",
                                               timeout_scale=0.6)
    want = jcoupling.split_schedule_from_engine(
        6, params=jparams.SimParams(net=jparams.NetworkParams(
            n_nodes=32, burst_on_prob=0.0008)), record=True,
        timeout_scale=0.6)
    for axis in ("intra", "cross"):
        a = getattr(got, axis).provenance
        b = getattr(want, axis).provenance
        assert (a.source, a.axis, a.tiers, a.phases) == (
            "recorded", b.axis, b.tiers, b.phases)
        np.testing.assert_allclose(a.rates, b.rates, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(a.phase_rates, b.phase_rates, rtol=1e-5,
                                   atol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcoupling.split_schedule_from_engine(2, params=SMOKE_T)


MIN_CODED, DROP = 1024, 0.1
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=500)


def test_hierarchical_step_matches_jax():
    """A single-device hierarchical step (smoke config, float32) against
    JAX's on the same weights, batch, masks and signs, held as
    tests/test_torch_train.py holds lossy_hadamard: the drop vector's
    cross component (its last) sets the masks."""
    jcfg = dataclasses.replace(JC.get_smoke("qwen2-0.5b"), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke("qwen2-0.5b"), dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    leaves = convert.jax_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jp)), tcfg)
    batch = jpipe.make_source(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4,
        seed=1)).global_batch(0)
    drop = np.array([0.05, 0.3, DROP], np.float32)   # [pod0, pod1, cross]
    jstep = jts.make_train_step(
        jcfg, None, jadamw.OptConfig(**OPT),
        jts.CelerisConfig(mode="hierarchical", min_coded_size=MIN_CODED),
        donate=False)
    key = jax.random.PRNGKey(5)
    jnew, jm = jstep({"params": jp, "opt": jadamw.init_opt_state(jp),
                      "step": jnp.zeros((), jnp.int32)},
                     {k: jnp.asarray(v) for k, v in batch.items()}, key,
                     jnp.asarray(drop))
    masks, signs = {}, {}
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jp)):
        if leaf.size >= MIN_CODED:
            plan = jcoding.plan_nd(leaf.shape, None, 4096)
            masks[i] = torch.as_tensor(np.array(jts._leaf_mask(
                key, i, 0, plan.n_rot, jnp.float32(DROP))))
            signs[i] = torch.as_tensor(np.array(jcoding.rademacher_nd(
                jax.random.fold_in(key, 2 * i), plan)))
    step = tts.make_train_step(
        tcfg, None, tadamw.OptConfig(**OPT),
        tts.CelerisConfig(mode="hierarchical", min_coded_size=MIN_CODED))
    new, m = step({"params": list(leaves),
                   "opt": tadamw.init_opt_state(leaves),
                   "step": torch.zeros((), dtype=torch.int32)},
                  {k: torch.as_tensor(v, dtype=torch.long)
                   for k, v in batch.items()}, None, drop, masks=masks,
                  signs=signs)
    assert len(masks) == 8
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(m["recv_frac"]) == pytest.approx(float(jm["recv_frac"]),
                                                  abs=1e-7)
    assert float(m["recv_frac"]) < 1.0
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    eps, lr, b1 = 1e-8, OPT["lr"], 0.9
    for got, want, mu, want_mu in zip(
            new["params"], jax.tree_util.tree_leaves(jnew["params"]),
            new["opt"]["mu"], jax.tree_util.tree_leaves(jnew["opt"]["mu"])):
        want, want_mu = np.asarray(want), np.asarray(want_mu)
        np.testing.assert_allclose(mu.numpy(), want_mu, atol=1e-8)
        g = np.abs(want_mu) / (1 - b1)
        dg = np.abs(mu.numpy() - want_mu) / (1 - b1)
        bound = 1e-7 + 2 * lr * eps * dg / (g + eps) ** 2
        assert np.all(np.abs(got.numpy() - want) <= bound)


def test_hierarchical_step_draws_at_the_cross_rate():
    """From one generator, hierarchical mode at [intra, cross] loses the
    rows lossy_hadamard loses at the cross rate alone."""
    cfg = TC.get_smoke("qwen2-0.5b")
    fracs = []
    for mode, drop in (("lossy_hadamard", 0.3),
                       ("hierarchical", np.array([0.01, 0.3])),
                       ("hierarchical", 0.3)):
        step = tts.make_train_step(cfg, None, tadamw.OptConfig(**OPT),
                                   tts.CelerisConfig(
                                       mode=mode, min_coded_size=MIN_CODED))
        leaves = tts.init_state(torch.Generator().manual_seed(0), cfg)
        batch = {k: torch.as_tensor(v, dtype=torch.long)
                 for k, v in tpipe.make_source(tpipe.DataConfig(
                     cfg.vocab_size, 16, 2, seed=1)).global_batch(0).items()}
        _, m = step(leaves, batch, torch.Generator().manual_seed(9), drop)
        fracs.append(float(m["recv_frac"]))
    assert fracs[0] == fracs[1] == fracs[2] < 0.8


def test_trainer_walks_a_hierarchical_schedule():
    """Three hierarchical steps of the smoke LM from a faulted 2-pod
    engine's axis split: the trainer's drop vectors are the schedule's."""
    sched = tcoupling.split_schedule_from_engine(
        SMOKE_ROUNDS, seed=0, params=SMOKE_T, n_pods=2, timeout_scale=0.6,
        fault="stall:0.003", device="cpu")
    cfg = TC.get_smoke("qwen2-0.5b")
    tr = ttrainer.Trainer(
        cfg, data_cfg=tpipe.DataConfig(cfg.vocab_size, 32, 4, seed=1),
        opt_cfg=tadamw.OptConfig(**OPT),
        celeris=tts.CelerisConfig(mode="hierarchical", min_coded_size=1024),
        straggler=tcoupling.HierStragglerModel(sched), device="cpu")
    hist = tr.run(3)
    for i, d in enumerate(hist["drop_rate"]):
        np.testing.assert_array_equal(d, sched.rates(i))
        assert d.shape == (3,)
    assert np.isfinite(hist["loss"]).all()
    assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"])


def test_hierarchical_mode_on_a_mesh_raises():
    """On a mesh without a 'pod' axis, as the JAX package refuses it."""
    with fake_world(4):
        mesh = tmesh.make_host_mesh((4, 1), device_type="cpu")
        with pytest.raises(ValueError, match="needs a 'pod' mesh axis"):
            tts.make_train_step(TC.get_smoke("qwen2-0.5b"), mesh, None,
                                tts.CelerisConfig(mode="hierarchical"))


@pytest.mark.parametrize("median,sigma", [(1.0, 0.6), (1.3, 0.45)])
def test_closed_form_schedule_matches_jax_and_the_straggler_model(median,
                                                                  sigma):
    """``LatencyTail`` is the trainer's StragglerModel with bursts off,
    and ``closed_form_schedule`` the JAX package's (atol 1e-12, as
    ``tests/test_coupling.py:71-81``); both are exported."""
    from repro_torch.core import transport as ttransport
    assert ttransport.LatencyTail is tcoupling.LatencyTail
    assert ttransport.closed_form_schedule is tcoupling.closed_form_schedule
    timeouts = np.linspace(0.2, 6.0, 23)
    tail = tcoupling.LatencyTail(median_latency=median, sigma=sigma)
    got = tcoupling.closed_form_schedule(timeouts, tail)
    want = jcoupling.closed_form_schedule(
        timeouts, jcoupling.LatencyTail(median_latency=median, sigma=sigma))
    np.testing.assert_allclose(got.rates, want.rates, atol=1e-12)
    assert got.source == want.source == "closed_form"
    sm = ttrainer.StragglerModel(median_latency=median, sigma=sigma,
                                 burst_prob=0.0)
    rng = np.random.default_rng(0)
    np.testing.assert_allclose(
        got.rates, [sm.drop_rate(t, rng) for t in timeouts], atol=1e-12)
    assert got.rates.max() <= tcoupling.MAX_DROP and got.rates.min() >= 0.0
    # the default tail, and a scalar timeout
    np.testing.assert_allclose(tcoupling.closed_form_schedule(2.0).rates,
                               jcoupling.closed_form_schedule(2.0).rates,
                               atol=1e-12)
