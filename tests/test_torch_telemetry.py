"""The port's flight recorder and Perfetto export against the JAX
package's, on the CPU (``tests/test_telemetry.py``'s tests but the
8-device mesh one, and the Fig.-9 keys).

- The recorder is a pure overlay: the port's stats with it on are bit
  for bit its stats with it off, and within the engine's contract of the
  committed seed stats.
- Its record equals the numpy engine's recorder on the same draws:
  packets (offered, delivered, wire- and fault-lost) and the fabric
  counters exact; components within rtol 1e-5.  The critical flow is the
  argmax of float32 times that agree with numpy's to ~1e-7, so
  ``crit_src``/``crit_tier`` and that step's split are compared wherever
  the numpy step's two largest times lie more than rtol 1e-5 apart; the
  near ties are named and counted, and there the component sum still
  agrees.
- The conservation audit passes and catches tampering; the export
  round-trips through its validator, streams in chunks and leaves no
  partial file.
- Provenance and the serve attribution ride the recorded record.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmarks import fig9_tail_attribution as jfig9
from repro.core.transport import coupling as jcoupling
from repro.core.transport import engine as jengine
from repro.core.transport import faults as jfaults
from repro.core.transport import network as jnetwork
from repro.core.transport import params as jparams
from repro.core.transport import telemetry as jtelemetry
from repro.core.transport import topology as jtopology
from repro.core.transport import trace_export as jexport
from repro.serve import traffic as jtraffic
from repro_torch.benchmarks import figs
from repro_torch.core.transport import ConservationError, TraceRecorder
from repro_torch.core.transport import coupling
from repro_torch.core.transport import engine as tengine
from repro_torch.core.transport import faults as tfaults
from repro_torch.core.transport import network as tnetwork
from repro_torch.core.transport import params as tparams
from repro_torch.core.transport import telemetry
from repro_torch.core.transport import topology as ttopology
from repro_torch.core.transport import trace_export
from repro_torch.serve import traffic as ttraffic

RTOL = 1e-5
BENCH = __file__.rsplit("/tests/", 1)[0] + "/BENCH_sim.json"
PINNED = __file__.rsplit("/", 1)[0] + "/data/ring_schedule_seed_stats.json"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(mod, **kw):
    return mod.SimParams(net=mod.NetworkParams(n_nodes=32,
                                               burst_on_prob=0.0008), **kw)


def _stall(mod):
    return mod.FaultParams(stall_rate=3e-4, stall_steps=40)


def _topo(mod):
    return jtopology if mod is jparams else ttopology


# the recorded cells: (params from a params module, seed, hierarchical)
CELLS = {
    "flat": (lambda m: _small(m), 11, False),
    "flat_stall": (lambda m: _small(m, fault=_stall(m)), 7, False),
    "pods2": (lambda m: _topo(m).hier_params(2, base=_small(m),
                                             dci_oversubscription=8.0),
              11, True),
    "pods2_stall": (lambda m: _topo(m).hier_params(
        2, base=_small(m), dci_oversubscription=4.0, fault=_stall(m)),
        1, True),
    "perrail2": (lambda m: _topo(m).hier_params(
        2, base=_small(m), dci_oversubscription=8.0, schedule="perrail"),
        3, True),
}


def _recorded(mod, params, seed, hier, *, recorder=True, scale=0.8,
              n_rounds=40):
    """One recorded pass of ``mod``'s engine (the JAX package's or the
    port's on the CPU): RoCE and Celeris, the fixed window at the paper
    rule x ``scale`` (``hier_protocol`` on the multi-pod cells)."""
    rec = (jtelemetry.TraceRecorder() if mod is jparams
           else TraceRecorder()) if recorder else None
    kw = {} if mod is jparams else {"device": "cpu"}
    if hier:
        st = _topo(mod).hier_protocol(params, n_rounds, seed,
                                      timeout_scale=scale, recorder=rec, **kw)
        return st["roce"], st["celeris"], rec
    E = jengine if mod is jparams else tengine
    eng = E.BatchedEngine(params, recorder=rec, **kw)
    tr = eng.traces(["roce", "celeris"], n_rounds, seed,
                    legacy_streams=False)
    base = eng.assemble(tr["roce"], seed)
    to = float(np.percentile(base.times_us, 50)
               + base.times_us.std()) * scale
    cel = eng.assemble(tr["celeris"], seed, celeris_timeout_us=to,
                       adaptive=False, window="round")
    return base, cel, rec


@pytest.fixture(scope="module")
def cells():
    out = {}
    for name, (params_of, seed, hier) in CELLS.items():
        out[name] = (_recorded(jparams, params_of(jparams), seed, hier),
                     _recorded(tparams, params_of(tparams), seed, hier))
    return out


def _near_ties(want_times_top2):
    a, b = want_times_top2
    return np.abs(a - b) <= RTOL * np.abs(a)


def _compare_records(got, want, top2=None):
    """The port's DesignRecord against the numpy engine's.  Returns the
    steps whose critical flow differs (all near ties)."""
    for f in ("offered_pkts", "delivered_pkts", "lost_pkts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.comp_tier, want.comp_tier, rtol=RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(got.comp_crit.sum(-1), want.comp_crit.sum(-1),
                               rtol=RTOL, atol=0)
    diff = np.flatnonzero((got.crit_src != want.crit_src)
                          | (got.crit_tier != want.crit_tier))
    ok = np.setdiff1d(np.arange(got.crit_src.size), diff)
    np.testing.assert_allclose(got.comp_crit[ok], want.comp_crit[ok],
                               rtol=RTOL, atol=1e-9)
    if diff.size:
        assert top2 is not None and _near_ties(top2)[diff].all(), (
            f"critical flow differs off a near tie at steps {diff}")
    for f in ("natural_us", "elapsed_us", "windowed_pkts",
              "window_cut_pkts", "prio_offered_pkts",
              "prio_window_cut_pkts"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6,
                                       err_msg=f)
    return diff


def _top2(params, seed, design, n_rounds=40):
    """The numpy engine's two largest flow times per step, from its
    per-node trace of the same pass."""
    eng = jengine.BatchedEngine(params)
    tr = eng.traces([design], n_rounds, seed, legacy_streams=False,
                    per_node_for=(design,))[design]
    t = np.sort(tr.node_time_us, axis=1)
    return t[:, -1], t[:, -2]


@pytest.mark.parametrize("design", ["roce", "celeris"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_record_matches_numpy_recorder(cells, cell, design):
    (jb, jc, jrec), (tb, tc, trec) = cells[cell]
    params_of, seed, _ = CELLS[cell]
    top2 = _top2(params_of(jparams), seed, design)
    diff = _compare_records(trec.record(design), jrec.record(design), top2)
    ties = int(_near_ties(top2).sum())
    print(f"{cell} {design}: {ties} near-tie steps, critical flow "
          f"differs at {diff.size} ({diff.tolist()})")
    for k in jrec.fabric:
        np.testing.assert_array_equal(trec.fabric[k], jrec.fabric[k],
                                      err_msg=k)
    assert sorted(trec.fabric) == sorted(jrec.fabric)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_recorder_is_pure_overlay(cells, cell):
    """Stats with the recorder on are the stats with it off, bit for
    bit, and the attribution conserves (``audit_round``)."""
    params_of, seed, hier = CELLS[cell]
    _, (tb, tc, trec) = cells[cell]
    ob, oc, _ = _recorded(tparams, params_of(tparams), seed, hier,
                          recorder=False)
    for on, off in ((tb, ob), (tc, oc)):
        for f in ("times_us", "recv_frac", "tier_recv_frac",
                  "pod_recv_frac", "prio_recv_frac", "fault_steps",
                  "affected_flows"):
            a, b = getattr(on, f), getattr(off, f)
            assert (a is None and b is None) or np.array_equal(a, b), f
    for st, d in ((tb, "roce"), (tc, "celeris")):
        out = telemetry.audit_round(st, trec.record(d))
        assert out["time_rel_err"] < 2e-5
        assert out["pkt_rel_err"] < 1e-9
        assert out["offered_vs_plan_rel_err"] < 1e-9


def test_recorder_on_flat_matches_pinned_and_conserves(cells):
    """tests/test_telemetry.py:61 on the port: the recorded stats are the
    committed seed stats within the engine's contract; the reliable
    design loses nothing and Celeris's per-cause split sums back to its
    loss."""
    with open(PINNED) as f:
        ref = json.load(f)["flat"]
    _, (base, cel, rec) = cells["flat"]
    np.testing.assert_allclose(base.times_us, ref["roce_times_us"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(cel.times_us, ref["celeris_times_us"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(cel.recv_frac, ref["celeris_recv_frac"],
                               rtol=RTOL, atol=0)
    r = rec.record("celeris")
    assert rec.record("roce").loss_rates().sum() == 0.0
    np.testing.assert_allclose(r.loss_rates().sum(axis=1),
                               1.0 - cel.recv_frac, atol=1e-9)
    assert r.loss_rates()[:, telemetry.CAUSES.index("window_cut")].sum() > 0


def test_recorder_on_two_pods_conserves(cells):
    """tests/test_telemetry.py:85: the 2-pod pass's attribution conserves
    with its pod accounting."""
    with open(PINNED) as f:
        ref = json.load(f)["pods2"]
    _, (_, cel, rec) = cells["pods2"]
    np.testing.assert_allclose(cel.times_us, ref["celeris_times_us"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(cel.tier_recv_frac,
                               ref["celeris_tier_recv_frac"], rtol=RTOL,
                               atol=0)
    out = telemetry.audit_round(cel, rec.record("celeris"))
    assert out["pkt_rel_err"] < 1e-9
    assert "pod_recomb_rel_err" in out


@pytest.mark.parametrize("cell", ["flat_stall", "pods2_stall"])
def test_faulted_runs_conserve_and_attribute(cells, cell):
    """NIC stalls show up as fault time on the reliable design and fault
    loss on Celeris, and everything still conserves."""
    _, (base, cel, rec) = cells[cell]
    for st, d in ((base, "roce"), (cel, "celeris")):
        telemetry.audit_round(st, rec.record(d))
    fcomp = rec.record("roce").round_components()[
        :, telemetry.COMPONENTS.index("fault")]
    assert fcomp.sum() > 0.0
    floss = rec.record("celeris").loss_rates()[
        :, telemetry.CAUSES.index("fault")]
    assert floss.sum() > 0.0


def test_incast_carve_out_matches_numpy():
    """The serve KV incast plan (fan-in 7): the incast component is the
    ``(1 - 1/fan)`` share of serialization, as the numpy recorder
    splits it."""
    tp_j = jtraffic.ServeTrafficParams(**figs.FIG8_SMOKE_TP)
    tp_t = ttraffic.ServeTrafficParams(**figs.FIG8_SMOKE_TP)
    out = []
    for mod, E, T, tp, kw in (
            (jparams, jengine, jtraffic, tp_j, {}),
            (tparams, tengine, ttraffic, tp_t, {"device": "cpu"})):
        p = mod.SimParams(net=dataclasses.replace(T.serve_net_params(tp),
                                                  burst_on_prob=0.0008))
        rec = (jtelemetry.TraceRecorder() if mod is jparams
               else TraceRecorder())
        eng = E.BatchedEngine(p, plan=T.kv_flow_plan(tp), recorder=rec, **kw)
        tr = eng.traces(["roce", "celeris"], 10, 0, legacy_streams=False)
        for d in ("roce", "celeris"):
            eng.assemble(tr[d], 0)
        out.append(rec)
    jrec, trec = out
    for d in ("roce", "celeris"):
        got, want = trec.record(d), jrec.record(d)
        _compare_records(got, want)
        inc = telemetry.COMPONENTS.index("incast")
        assert got.comp_tier[..., inc].sum() > 0.0


def test_audit_catches_tampered_record(cells):
    """A silently dropped update undercounts a component or a loss
    column: both must raise."""
    _, (_, cel, rec) = cells["flat"]
    r = rec.record("celeris")
    keep = r.comp_crit.copy(), r.lost_pkts.copy()
    try:
        r.comp_crit[:, 0] *= 0.5              # lose half the serialize time
        with pytest.raises(ConservationError):
            telemetry.audit_round(cel, r)
        r.comp_crit[:] = keep[0]
        r.lost_pkts[:, :, 0] += 7.0           # phantom wire loss
        with pytest.raises(ConservationError):
            telemetry.audit_round(cel, r)
    finally:
        r.comp_crit[:], r.lost_pkts[:] = keep


def test_recorder_rejects_legacy_streams():
    eng = tengine.BatchedEngine(_small(tparams), recorder=TraceRecorder(),
                                device="cpu")
    with pytest.raises(ValueError, match="legacy_streams"):
        eng.traces(["roce"], 10, 0, legacy_streams=True)
    # run() routes to the shared fabric instead of raising
    st = eng.run("roce", 5, seed=3)
    assert st.times_us.shape == (5,)


def test_recorder_records_one_seed_a_pass():
    from repro_torch.core.transport import engine_torch
    eng = tengine.BatchedEngine(_small(tparams), recorder=TraceRecorder(),
                                device="cpu")
    with pytest.raises(ValueError, match="one seed"):
        engine_torch.traces_batched(eng, ["roce"], 2, [0, 1])


def test_unassembled_record_fails_audit():
    rec = TraceRecorder()
    eng = tengine.BatchedEngine(_small(tparams), recorder=rec, device="cpu")
    eng.traces(["roce"], 5, 0, legacy_streams=False)
    st = tengine.BatchedEngine(_small(tparams), device="cpu").run(
        "roce", 5, seed=0)
    with pytest.raises(ConservationError, match="not assembled"):
        telemetry.audit_round(st, rec.record("roce"))
    with pytest.raises(KeyError, match="no record"):
        rec.record("irn")


def test_congestion_counters_match_numpy():
    rng = np.random.default_rng(0)
    occ = rng.random((7, 9)).astype(np.float32)
    drop = rng.random((7, 9))
    net_t, net_j = tparams.NetworkParams(), jparams.NetworkParams()
    got = tnetwork.congestion_counters(net_t, occ, drop)
    want = jnetwork.congestion_counters(net_j, occ, drop)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


class _Res:
    def __init__(self, t, d):
        self.time_us, self.delivered_pkts = t, d


@pytest.mark.parametrize("design", ["roce", "irn", "srnic", "celeris"])
def test_fault_parts_match_numpy(design):
    """``apply_to_result(parts=)``: the fault time and fault-lost packets
    the numpy overlay records, on torch tensors; the returned times and
    packets are the ones without ``parts``."""
    rng = np.random.default_rng(1)
    t = (rng.random((5, 8)) * 100).astype(np.float32)
    n_pkts = 12
    d = (n_pkts - rng.integers(0, 3, (5, 8))).astype(np.float32)
    blocked = rng.random((5, 8)) < 0.3
    dead = (rng.random((5, 8)) < 0.2) & ~blocked
    rel_t, rel_j = tparams.ReliabilityParams(), jparams.ReliabilityParams()
    full = np.full((5, 8), float(n_pkts))
    res = _Res(t.copy(), d.copy() if design == "celeris"
               else np.broadcast_to(full, (5, 8)))
    want = {}
    jfaults.apply_to_result(design, res, blocked, dead, rel_j, parts=want)
    parts = {}
    args = (torch.from_numpy(t), torch.from_numpy(d) if design == "celeris"
            else None, torch.from_numpy(blocked), torch.from_numpy(dead),
            rel_t)
    tt, dd = tfaults.apply_to_result(design, *args, parts=parts,
                                     offered=n_pkts)
    t0, d0 = tfaults.apply_to_result(design, *args)
    assert torch.equal(tt, t0)
    assert (dd is None and d0 is None) or torch.equal(dd, d0)
    np.testing.assert_array_equal(tt.numpy(), res.time_us)
    for k in ("fault", "fault_lost"):
        np.testing.assert_array_equal(parts[k].numpy(), want[k], err_msg=k)


def test_fault_parts_need_offered():
    """``parts=`` without ``offered=`` raises rather than recording a
    dead reliable flow as losing no packets."""
    t = torch.ones(2, 3)
    dead = torch.tensor([[True, False, False], [False, False, True]])
    with pytest.raises(ValueError, match="offered"):
        tfaults.apply_to_result("roce", t, None, None, dead,
                                tparams.ReliabilityParams(), parts={})


# ------------------------------------------------------- export schema

@pytest.fixture(scope="module")
def short_recording():
    return _recorded(tparams, _small(tparams), 11, False, n_rounds=10)


def test_trace_export_roundtrips(short_recording, tmp_path):
    _, _, rec = short_recording
    path = tmp_path / "trace.json"
    trace_export.write_trace(rec, str(path), meta={"test": "yes"})
    with open(path) as f:
        loaded = json.load(f)
    counts = trace_export.validate_trace(loaded)
    assert counts["X"] > 0 and counts["M"] > 0
    pids = {e["pid"] for e in loaded["traceEvents"] if e["ph"] == "X"}
    assert len(pids) == 2
    for e in loaded["traceEvents"]:
        if e["ph"] == "X" and "components_us" in e.get("args", {}):
            assert set(e["args"]["components_us"]) <= set(
                telemetry.COMPONENTS)
    # the JAX package's validator takes the port's export
    assert jexport.validate_trace(loaded) == counts


def test_trace_export_matches_numpy_schema(cells):
    """The port's export of a recorded pass has the numpy engine's
    events: the same names, phases, tracks and argument keys, event for
    event (their values ride the components' rtol)."""
    (_, _, jrec), (_, _, trec) = cells["pods2_stall"]
    a = trace_export.to_trace_events(trec, max_rounds=5)
    b = jexport.to_trace_events(jrec, max_rounds=5)
    assert len(a["traceEvents"]) == len(b["traceEvents"])
    for x, y in zip(a["traceEvents"], b["traceEvents"]):
        assert (x["name"], x["ph"], x["pid"], x["tid"]) == (
            y["name"], y["ph"], y["pid"], y["tid"])
    assert {k: v for k, v in a["otherData"].items() if k != "generator"} \
        == {k: v for k, v in b["otherData"].items() if k != "generator"}


def test_trace_validator_rejects_corruption(short_recording):
    _, _, rec = short_recording
    obj = trace_export.to_trace_events(rec, max_rounds=5)
    trace_export.validate_trace(json.loads(json.dumps(obj)))

    bad = json.loads(json.dumps(obj))
    del bad["traceEvents"][0]["name"]
    with pytest.raises(ValueError):
        trace_export.validate_trace(bad)

    bad = json.loads(json.dumps(obj))
    for e in bad["traceEvents"]:
        if e["ph"] == "X":
            e["dur"] = -1.0
            break
    with pytest.raises(ValueError):
        trace_export.validate_trace(bad)

    bad = json.loads(json.dumps(obj))
    for e in bad["traceEvents"]:
        if e["ph"] == "X" and "components_us" in e.get("args", {}):
            e["args"]["components_us"]["not_a_component"] = 1.0
            break
    with pytest.raises(ValueError):
        trace_export.validate_trace(bad)

    with pytest.raises(ValueError, match="no records"):
        trace_export.to_trace_events(TraceRecorder())


def test_trace_export_streams_in_chunks(short_recording, tmp_path):
    """The chunked generator is event-identical to the whole object, the
    streamed file parses to the same trace for any chunk size, and every
    chunk passes the per-chunk gate."""
    _, _, rec = short_recording
    whole = trace_export.to_trace_events(rec, meta={"test": "yes"})
    chunks = list(trace_export.iter_trace_events(rec, chunk_rounds=3))
    assert len(chunks) > 2
    for c in chunks:
        trace_export.validate_events(c)
    assert [e for c in chunks for e in c] == whole["traceEvents"]
    ref = None
    for chunk_rounds in (1, 3, 1000):
        path = tmp_path / f"trace_{chunk_rounds}.json"
        counts = trace_export.write_trace(rec, str(path), meta={"test": "yes"},
                                          chunk_rounds=chunk_rounds)
        with open(path) as f:
            loaded = json.load(f)
        assert trace_export.validate_trace(loaded) == counts
        assert loaded["traceEvents"] == whole["traceEvents"]
        assert loaded["otherData"] == json.loads(
            json.dumps(whole["otherData"]))
        ref = ref or loaded
        assert loaded == ref
    with pytest.raises(ValueError, match="chunk_rounds"):
        list(trace_export.iter_trace_events(rec, chunk_rounds=0))


def test_write_trace_removes_partial_file_on_invalid_chunk(
        short_recording, tmp_path, monkeypatch):
    _, _, rec = short_recording
    real_iter = trace_export.iter_trace_events

    def poisoned(recorder, **kw):
        for i, chunk in enumerate(real_iter(recorder, **kw)):
            if i == 1:      # corrupt the first round chunk, after metadata
                chunk[0] = dict(chunk[0], ph="Z")
            yield chunk

    monkeypatch.setattr(trace_export, "iter_trace_events", poisoned)
    path = tmp_path / "trace.json"
    with pytest.raises(ValueError, match="unknown ph"):
        trace_export.write_trace(rec, str(path), chunk_rounds=2)
    assert not path.exists()


# --------------------------------------------------- drop provenance

def test_flat_schedule_provenance_recorded_vs_heuristic():
    """tests/test_telemetry.py:217: ``record=True`` changes only the
    provenance, which explains exactly the clipped rates; the recorded
    split equals the JAX package's within the contract."""
    kw = dict(params=_small(tparams), timeout_scale=0.8, device="cpu")
    rec_sched = coupling.schedule_from_engine(40, 11, record=True, **kw)
    heu_sched = coupling.schedule_from_engine(40, 11, record=False, **kw)
    np.testing.assert_array_equal(rec_sched.rates, heu_sched.rates)
    p = rec_sched.provenance
    assert p.source == "recorded"
    assert heu_sched.provenance.source == "heuristic"
    np.testing.assert_allclose(np.clip(p.total(), 0.0, coupling.MAX_DROP),
                               rec_sched.rates, atol=1e-9)
    assert p.dominant_cause() == "window_cut"
    assert p.phases and p.phase_rates is not None
    assert "window_cut" in p.describe()
    want = jcoupling.schedule_from_engine(40, 11, params=_small(jparams),
                                          timeout_scale=0.8, record=True)
    np.testing.assert_allclose(p.rates, want.provenance.rates, rtol=RTOL,
                               atol=1e-9)
    assert p.phases == want.provenance.phases


def test_split_schedule_provenance_per_axis():
    sp = coupling.split_schedule_from_engine(
        30, seed=4, params=_small(tparams), n_pods=2,
        dci_oversubscription=8.0, timeout_scale=0.8, record=True,
        device="cpu")
    for axis, sched in (("intra", sp.intra), ("cross", sp.cross)):
        p = sched.provenance
        assert p is not None and p.axis == axis and p.source == "recorded"
        np.testing.assert_allclose(
            np.clip(p.total(), 0.0, coupling.MAX_DROP), sched.rates,
            atol=1e-9)
    assert sp.cross.provenance.tiers == ("dci",)


# -------------------------------------------------------- serve path

def test_serve_loss_attribution_is_pure_overlay(cells):
    """tests/test_telemetry.py:303 on the port: the recorded per-cause
    rates attribute every request's KV loss without moving the FIFO
    simulation."""
    _, (_, cel, rec) = cells["flat"]
    lr = rec.record("celeris").loss_rates()
    tp = ttraffic.ServeTrafficParams()
    ref = float(np.median(cel.times_us))
    trace = ttraffic.request_trace(tp, float(cel.times_us.sum()), ref, seed=3)
    res0 = ttraffic.simulate_serving(tp, cel.times_us, cel.recv_frac, trace)
    res = ttraffic.simulate_serving(tp, cel.times_us, cel.recv_frac, trace,
                                    loss_rates=lr)
    np.testing.assert_array_equal(res.latency_us, res0.latency_us)
    np.testing.assert_array_equal(res.kv_frac, res0.kv_frac)
    np.testing.assert_array_equal(res.completed, res0.completed)
    assert res0.kv_loss_by_cause is None
    assert res.kv_loss_by_cause is not None
    done = res.completed
    np.testing.assert_allclose(res.kv_loss_by_cause[done].sum(axis=1),
                               1.0 - res.kv_frac[done], atol=1e-9)
    attr = res.loss_attribution()
    assert set(attr) == set(telemetry.CAUSES)
    assert attr["window_cut"] >= 0.0


# ------------------------------------------------------------- Fig. 9

def _committed(keys):
    with open(BENCH) as f:
        bench = json.load(f)
    return {k: bench.get(k) for k in keys}


def test_smoke_fig9_keys_exact_and_deterministic():
    a, _ = figs.smoke_fig9_keys("cpu")
    b, _ = figs.smoke_fig9_keys("cpu")
    assert a == b and len(a) == 19
    assert a == _committed(a)
    assert a["smoke_fig9_celeris_tailex_datapath_share"] == 1.0


def test_fig9_flat_cell_exact():
    """Fig. 9's 128-node flat cell (60 rounds, p99 tail): its keys at the
    committed digits, and the numpy engine's record beside the port's."""
    cells, _, timing = figs.fig9_recorded_pair(
        tparams.SimParams(net=tparams.NetworkParams(n_nodes=figs.FIG9_NODES)),
        figs.FIG9_ROUNDS, 0, figs.TAIL_SCALE, "cpu")
    keys = {}
    _, audits = figs.fig9_cell_keys(cells, 99.0, "fig9", "", keys)
    assert keys == _committed(keys) and len(keys) == 18
    assert timing["record_bytes"] > 0
    want, _ = jfig9._recorded_pair(
        jparams.SimParams(net=jparams.NetworkParams(n_nodes=jfig9.NODES)),
        jfig9.N_ROUNDS, 0, jfig9.TAIL_SCALE)
    for d in ("roce", "celeris"):
        top2 = _top2(jparams.SimParams(net=jparams.NetworkParams(
            n_nodes=jfig9.NODES)), 0, d, jfig9.N_ROUNDS)
        _compare_records(cells[d][1], want[d][1], top2)
        assert audits[d]["time_rel_err"] < 2e-5



def test_fig9_protocol_constants_match_reference():
    assert (figs.FIG9_NODES, figs.FIG9_ROUNDS) == (jfig9.NODES,
                                                   jfig9.N_ROUNDS)
    assert figs.FIG9_FAULT_CELL == jfig9.FAULT_CELL
    assert (figs.TAIL_SCALE, figs.SMOKE_TAIL_SCALE) == (
        jfig9.TAIL_SCALE, jfig9.SMOKE_TAIL_SCALE)
    assert tuple(figs._RECOVERY) == tuple(jfig9._RECOVERY)
    mine, theirs = figs.smoke_params().net, jfig9.SMOKE_PARAMS.net
    assert (mine.n_nodes, mine.burst_on_prob) == (theirs.n_nodes,
                                                  theirs.burst_on_prob)
