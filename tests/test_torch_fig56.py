"""Figs. 5 and 6 from the port's engine on the CPU, through
``repro_torch.benchmarks.figs``, the functions the card runs at the full
tiers: the smoke tiers of ``benchmarks/fig5_schedule_tail.py`` (ring vs
hier, 2 pods, 32 nodes, 60 rounds, through ``hier_protocol``) and
``benchmarks/fig6_scale_schedule.py`` ({hier, perrail} x {round, phase},
2 pods, 32 nodes, 40 rounds, budget x 0.4, through ``sweep``), and the
full tiers' protocols on cut grids: Fig. 5's 4-pod oversubscription-2
cell with the hot pod, Fig. 6 at 128 nodes.  Every key must equal the
committed ``BENCH_sim.json`` value at its printed digits (tolerance: none;
the numpy engine committed them on the CPU).
"""
import dataclasses
import json
import os

import pytest
import torch

from benchmarks import budgets
from benchmarks import fig5_schedule_tail as fig5
from benchmarks import fig6_scale_schedule as fig6
from benchmarks import fig8_serving_tail as fig8
from repro_torch.benchmarks import figs

BENCH = os.path.join(os.path.dirname(__file__), os.pardir, "BENCH_sim.json")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _committed(prefix):
    with open(BENCH) as f:
        return {k: v for k, v in json.load(f).items() if k.startswith(prefix)}


def test_protocol_constants_match_reference():
    assert (figs.FIG5_PODS, figs.FIG5_OVERSUBS, figs.FIG5_NODES) == (
        fig5.POD_COUNTS, fig5.OVERSUBS, fig5.SWEEP_NODES)
    assert (figs.FIG5_HOTPOD_BASE, figs.FIG5_HOTPOD_HOT) == (
        fig5.HOTPOD_BASE, fig5.HOTPOD_HOT)
    assert figs.smoke_params().net.n_nodes == fig5.SMOKE_PARAMS.net.n_nodes
    assert (figs.smoke_params().net.burst_on_prob
            == fig5.SMOKE_PARAMS.net.burst_on_prob
            == fig6.SMOKE_PARAMS.net.burst_on_prob)
    t = figs.FIG6
    assert (t.nodes, t.oversubs, t.schedules, t.pods) == (
        fig6.NODES, fig6.OVERSUBS, fig6.SCHEDULES, fig6.N_PODS)
    assert figs.FIG6_WINDOWS == fig6.WINDOWS
    assert (t.tail_scale, figs.FIG6_SMOKE.tail_scale) == (
        budgets.TAIL_SCALE, budgets.SMOKE_TAIL_SCALE)
    assert (figs.FIG8_LOADS, figs.FIG8_ROUNDS, figs.FIG8_DESIGNS) == (
        fig8.LOADS, fig8.N_ROUNDS, fig8.DESIGNS)
    assert (figs.FIG8_SMOKE_LOADS, figs.FIG8_SMOKE_ROUNDS) == (
        fig8.SMOKE_LOADS, fig8.SMOKE_ROUNDS)
    for mine, theirs in ((figs.FIG8_TP, fig8.FULL_TP),
                         (figs.FIG8_SMOKE_TP, fig8.SMOKE_TP)):
        assert (mine["n_prefill"], mine["n_decode"]) == (
            theirs.n_prefill, theirs.n_decode)
    assert (figs.FIG8_SLO_SCALE, figs.FIG8_N_ROT, figs.FIG8_TAU,
            figs.FIG8_GEN) == (fig8.SLO_SCALE, fig8.N_ROT, fig8.TAU,
                               fig8.RECOVERY_GEN)


def test_smoke_fig5_gives_committed_keys():
    keys, protocol = figs.smoke_fig5_keys("cpu")
    want = _committed("smoke_fig5_")
    assert len(want) == 4 and keys == want
    assert len(protocol) == 2


def test_fig5_protocol_on_cut_grid_gives_committed_keys():
    """The full tier's code on one cell of its grid (4 pods,
    oversubscription 2) and the hot pod beside it."""
    keys, sweeps, protocol = figs.fig5_keys("cpu", pods=(4,),
                                            oversubs=(2.0,))
    want = {k: v for k, v in _committed("fig5_").items()
            if k.endswith("_p4_o2") or k in ("fig5_uniform_p99_ms",
                                             "fig5_hotpod_p99_ms")}
    assert len(want) == 7 and keys == want
    assert len(sweeps) == len(protocol) == 1


def test_smoke_fig6_gives_committed_keys():
    keys, sweeps = figs.fig6_keys(figs.FIG6_SMOKE, "cpu")
    want = _committed("smoke_fig6_")
    assert len(want) == 13 and keys == want
    (res,) = sweeps
    assert len(res.timing) == 2      # one engine pass per schedule


def test_fig6_protocol_at_128_nodes_gives_committed_keys():
    """The full tier's code at its smallest scale: both
    oversubscriptions, every schedule and window."""
    keys, sweeps = figs.fig6_keys(dataclasses.replace(figs.FIG6,
                                                      nodes=(128,)), "cpu")
    want = {k: v for k, v in _committed("fig6_").items() if "_n128_" in k}
    assert len(want) == 42 and keys == want
    assert len(sweeps) == 2
