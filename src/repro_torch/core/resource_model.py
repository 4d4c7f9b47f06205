"""FPGA resource + MTBF analytic model (paper Table II; a copy of
``repro/core/resource_model.py``, plain Python).

This container cannot run Vivado synthesis, so Table II is reproduced
through a *structural* analytic model:

- **BRAM** is built bottom-up: a common NIC-shell component plus the
  per-QP context SRAM (from :mod:`repro_torch.core.qp_state`, scaled by QP
  count) plus per-design reliability buffers (retransmission queues,
  reorder buffers, SACK engines).  At the paper's 10K-QP operating point
  the component sums equal Table II exactly; the model stays predictive
  at other QP counts.
- **LUT / LUTRAM / FF / Power** are the paper's published synthesis
  results, kept as calibrated per-design constants (base + reliability
  logic deltas).
- **MTBF** is *recomputed from first principles* with the Xilinx-SEU
  two-component model::

      upsets/hour/node = FIT_bit x (BRAM_bits + essential_ratio x CRAM_bits)
      MTBF_cluster     = 1 / (upsets/hour/node x n_nodes)

  with ``essential_ratio = 0.10`` (paper's 10% CRAM essential-bit ratio),
  ``CRAM_bits ~= 692 x LUTs`` (config + routing bits per LUT,
  UltraScale+-plausible), and the per-bit rate calibrated on the RoCE row
  only (2.07e-14 upsets/bit/hour at 100 degC ~= 20.7 FIT/Mbit — in the
  published UltraScale SEU range after temperature derating).  The other
  three designs' MTBFs are then *predictions* — they land within ~1% of
  Table II, which is the model-validation test in
  ``tests/test_resource_model.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import qp_state

BRAM_BLOCK_BITS = 36 * 1024          # one BRAM36 block
BYTES_PER_BRAM_BLOCK = BRAM_BLOCK_BITS // 8

# --- MTBF model constants (see module docstring) ----------------------
ESSENTIAL_RATIO = 0.10               # paper: 10% CRAM essential bits
CRAM_BITS_PER_LUT = 692.0            # config+routing bits per LUT (calibrated)
FIT_PER_BIT_HOUR = 2.0743e-14        # calibrated on RoCE @ 100 degC
DEFAULT_NODES = 15_000               # paper: 15,000-node datacenter

# --- Published synthesis constants (Vivado 2022.1, Alveo U250, 10K QPs) ---
_PAPER_LUT = {"roce": 312_449, "irn": 319_567, "srnic": 304_497, "celeris": 298_435}
_PAPER_LUTRAM = {"roce": 23_277, "irn": 24_221, "srnic": 22_460, "celeris": 21_743}
_PAPER_FF = {"roce": 562_129, "irn": 573_116, "srnic": 551_526, "celeris": 542_972}
_PAPER_POWER_W = {"roce": 34.7, "irn": 35.9, "srnic": 33.5, "celeris": 32.5}
PAPER_BRAM = {"roce": 1450.5, "irn": 1941.5, "srnic": 939.5, "celeris": 529.5}
PAPER_MTBF_HRS = {"roce": 42.8, "irn": 34.3, "srnic": 57.8, "celeris": 80.5}

CALIBRATION_QPS = 10_000


@dataclasses.dataclass(frozen=True)
class BramBreakdown:
    """BRAM36 blocks by component at a given QP count."""
    shell: float               # DMA, parser, MMU, packet FIFOs, CC tables
    qp_context: float          # per-QP SRAM (scales with n_qps)
    retransmit_buffers: float  # go-back-N / selective-repeat payload staging
    reorder_buffers: float     # OOO reassembly / IRRQ
    tracking: float            # bitmaps / SACK engines / doorbell queues

    @property
    def total(self) -> float:
        return (self.shell + self.qp_context + self.retransmit_buffers
                + self.reorder_buffers + self.tracking)


def _ctx_blocks(design: str, n_qps: int) -> float:
    return qp_state.qp_bytes(design) * n_qps / BYTES_PER_BRAM_BLOCK


# Per-design non-context components, calibrated so totals match Table II
# at 10K QPs.  SRNIC's shell is slightly smaller (no WQE-cache FIFO path).
_NON_CTX = {
    "roce":    dict(shell=416.65, retransmit_buffers=112.0, reorder_buffers=38.6, tracking=0.0),
    "irn":     dict(shell=416.65, retransmit_buffers=0.0, reorder_buffers=158.0, tracking=73.44),
    "srnic":   dict(shell=401.63, retransmit_buffers=0.0, reorder_buffers=0.0, tracking=12.7),
    "celeris": dict(shell=416.65, retransmit_buffers=0.0, reorder_buffers=0.0, tracking=0.0),
}


def bram_breakdown(design: str, n_qps: int = CALIBRATION_QPS) -> BramBreakdown:
    parts = _NON_CTX[design]
    return BramBreakdown(qp_context=_ctx_blocks(design, n_qps), **parts)


def bram_blocks(design: str, n_qps: int = CALIBRATION_QPS) -> float:
    return bram_breakdown(design, n_qps).total


def lut(design: str) -> int:
    return _PAPER_LUT[design]


def lutram(design: str) -> int:
    return _PAPER_LUTRAM[design]


def ff(design: str) -> int:
    return _PAPER_FF[design]


def power_w(design: str) -> float:
    return _PAPER_POWER_W[design]


# ----------------------------------------------------------------------
# MTBF (SEU) model
# ----------------------------------------------------------------------

def essential_bits(design: str, n_qps: int = CALIBRATION_QPS) -> float:
    bram_bits = bram_blocks(design, n_qps) * BRAM_BLOCK_BITS
    cram_bits = CRAM_BITS_PER_LUT * lut(design)
    return bram_bits + ESSENTIAL_RATIO * cram_bits


def node_upset_rate(design: str, n_qps: int = CALIBRATION_QPS) -> float:
    """Upsets per hour for one NIC."""
    return FIT_PER_BIT_HOUR * essential_bits(design, n_qps)


def cluster_mtbf_hours(design: str, n_nodes: int = DEFAULT_NODES,
                       n_qps: int = CALIBRATION_QPS) -> float:
    return 1.0 / (node_upset_rate(design, n_qps) * n_nodes)


# ----------------------------------------------------------------------
# ASIC scaling (paper: ~57% less silicon than IRN, ~28% less than SRNIC)
# ----------------------------------------------------------------------

# Standard FPGA->ASIC scaling: logic ~ LUT-equivalents, memory ~ bits.
# Area(a.u.) = logic_area_per_lut*LUT + mem_area_per_bit*BRAM_bits, with
# memory denser on ASIC than logic (7nm SRAM macro vs std-cell).
# Solved from the paper's own two area claims (-57% vs IRN, -28% vs
# SRNIC) which are mutually consistent at ~69 bit-equivalents per LUT.
_ASIC_LOGIC_PER_LUT = 69.0
_ASIC_MEM_PER_BIT = 1.0


def asic_area_au(design: str, n_qps: int = CALIBRATION_QPS) -> float:
    return (_ASIC_LOGIC_PER_LUT * lut(design)
            + _ASIC_MEM_PER_BIT * bram_blocks(design, n_qps) * BRAM_BLOCK_BITS)


def table2(n_qps: int = CALIBRATION_QPS, n_nodes: int = DEFAULT_NODES) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for d in ("roce", "irn", "srnic", "celeris"):
        out[d] = dict(
            lut=lut(d), lutram=lutram(d), ff=ff(d),
            bram=round(bram_blocks(d, n_qps), 1),
            power_w=power_w(d),
            mtbf_hrs=round(cluster_mtbf_hours(d, n_nodes, n_qps), 1),
            asic_area_au=round(asic_area_au(d, n_qps), 0),
        )
    return out
