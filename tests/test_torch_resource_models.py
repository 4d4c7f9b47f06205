"""The port's copies of ``qp_state`` and ``resource_model`` (Tables I-II)
against the JAX package's modules.

Both are plain Python, so every public function must return exactly the
reference's value (tolerance: none; ``==`` on ints, floats and the
field lists) for each design, over a grid of QP counts, SRAM budgets and
node counts; and the port's Tables I-II must hold the paper values that
``tests/test_resource_models.py`` holds the reference to.
"""
import dataclasses

import pytest

import chip_smoke
from repro.core import qp_state as jqp
from repro.core import resource_model as jrm
from repro_torch.benchmarks import figs
from repro_torch.core import qp_state as tqp
from repro_torch.core import resource_model as trm

DESIGNS = ("roce", "irn", "srnic", "celeris")
QPS = (1, 1_000, 10_000, 40_000, 80_000, 250_000)
SRAM = (1 << 20, 4_160_000, 16 << 20)
NODES = (1, 1_000, 15_000, 100_000)


def _fields(fs):
    return [dataclasses.astuple(f) for f in fs]


def test_constants_match():
    for name in ("SRNIC_COYOTE_BYTES", "PAPER_QP_BYTES",
                 "PAPER_QP_SCALABILITY"):
        assert getattr(tqp, name) == getattr(jqp, name), name
    for name in ("BRAM_BLOCK_BITS", "BYTES_PER_BRAM_BLOCK", "ESSENTIAL_RATIO",
                 "CRAM_BITS_PER_LUT", "FIT_PER_BIT_HOUR", "DEFAULT_NODES",
                 "PAPER_BRAM", "PAPER_MTBF_HRS", "CALIBRATION_QPS"):
        assert getattr(trm, name) == getattr(jrm, name), name
    assert tqp.DESIGNS.keys() == jqp.DESIGNS.keys()


@pytest.mark.parametrize("design", DESIGNS)
def test_qp_state_matches(design):
    assert _fields(tqp.DESIGNS[design]) == _fields(jqp.DESIGNS[design])
    ctx = {"roce": "roce_context", "irn": "irn_context",
           "srnic": "srnic_context", "celeris": "celeris_context"}[design]
    assert _fields(getattr(tqp, ctx)()) == _fields(getattr(jqp, ctx)())
    assert tqp.qp_bytes(design) == jqp.qp_bytes(design)
    assert tqp.category_breakdown(design) == jqp.category_breakdown(design)
    assert (tqp.reliability_state_bytes(design)
            == jqp.reliability_state_bytes(design))
    assert tqp.qp_capacity(design) == jqp.qp_capacity(design)
    for sram in SRAM:
        assert tqp.qp_capacity(design, sram) == jqp.qp_capacity(design, sram)


def test_table1_matches():
    assert tqp.table1() == jqp.table1()


@pytest.mark.parametrize("design", DESIGNS)
def test_resource_model_matches(design):
    for fn in ("lut", "lutram", "ff", "power_w"):
        assert getattr(trm, fn)(design) == getattr(jrm, fn)(design), fn
    assert trm.bram_blocks(design) == jrm.bram_blocks(design)
    assert trm.cluster_mtbf_hours(design) == jrm.cluster_mtbf_hours(design)
    for n_qps in QPS:
        assert (dataclasses.astuple(trm.bram_breakdown(design, n_qps))
                == dataclasses.astuple(jrm.bram_breakdown(design, n_qps)))
        assert (trm.bram_breakdown(design, n_qps).total
                == jrm.bram_breakdown(design, n_qps).total)
        for fn in ("bram_blocks", "essential_bits", "node_upset_rate",
                   "asic_area_au"):
            assert (getattr(trm, fn)(design, n_qps)
                    == getattr(jrm, fn)(design, n_qps)), (fn, n_qps)
        for n_nodes in NODES:
            assert (trm.cluster_mtbf_hours(design, n_nodes, n_qps)
                    == jrm.cluster_mtbf_hours(design, n_nodes, n_qps))


@pytest.mark.parametrize("n_qps", QPS)
@pytest.mark.parametrize("n_nodes", NODES)
def test_table2_matches(n_qps, n_nodes):
    assert trm.table2(n_qps, n_nodes) == jrm.table2(n_qps, n_nodes)


def test_table_keys_equal_reference_and_paper():
    """The Tables I-II keys on the port's modules equal those on the
    reference modules, and chip_smoke's Tables I-II phase (the paper's
    bars) holds."""
    assert figs.table_keys() == figs.table_keys(tqp, trm)
    assert figs.table_keys(tqp, trm) == figs.table_keys(jqp, jrm)
    rec = chip_smoke.phase_tables(figs, tqp, trm)
    assert rec["table2_bram_cut_vs_irn_pct"] == 72.7
    assert rec["table1_qp_density_gain"] == 7.83
