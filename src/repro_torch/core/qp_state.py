"""Per-QP NIC context accounting (paper Table I; a copy of
``repro/core/qp_state.py``, plain Python).

Each RDMA NIC design keeps a per-queue-pair (QP) context in on-chip SRAM.
The byte layouts below are field-level inventories that reproduce the
paper's per-QP totals exactly:

    RoCE  407 B   (go-back-N, PFC, WQE cache)
    IRN   596 B   (selective repeat + SACK bitmaps in NIC)
    SRNIC 242 B   (retransmission/reordering offloaded to host SW)
    Celeris 52 B  (best-effort: 20 B base + 32 B DCQCN)

Note: the paper's evaluation text says the Coyote SRNIC port used 210 B;
Table I lists 242 B for the design itself.  We model the design (242 B)
and expose the Coyote port variant as ``SRNIC_COYOTE_BYTES``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

SRNIC_COYOTE_BYTES = 210


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    bytes: int
    category: str  # "addressing" | "reliability" | "ordering" | "cc" | "wqe"


def _f(name: str, nbytes: int, cat: str) -> Field:
    return Field(name, nbytes, cat)


# ----------------------------------------------------------------------
# Shared building blocks
# ----------------------------------------------------------------------

_BASE_ADDRESSING: List[Field] = [
    _f("qpn", 3, "addressing"),
    _f("dest_qpn", 3, "addressing"),
    _f("dest_ip", 4, "addressing"),
    _f("remote_base_va", 8, "addressing"),
    _f("rkey", 4, "addressing"),
    _f("pd_handle", 3, "addressing"),
    _f("mtu_log2_state_flags", 1, "addressing"),
]  # = 26 B

_DCQCN: List[Field] = [
    _f("rate_current", 4, "cc"),
    _f("rate_target", 4, "cc"),
    _f("alpha", 4, "cc"),
    _f("byte_counter", 4, "cc"),
    _f("timer_rate_increase", 4, "cc"),
    _f("timer_alpha_update", 4, "cc"),
    _f("bc_stage_count", 4, "cc"),
    _f("t_stage_count", 4, "cc"),
]  # = 32 B


def _sum(fields: List[Field]) -> int:
    return sum(f.bytes for f in fields)


# ----------------------------------------------------------------------
# Per-design layouts
# ----------------------------------------------------------------------

def celeris_context() -> List[Field]:
    """20 B push-engine context + 32 B DCQCN = 52 B.

    No PSNs, no retry counters, no timers, no windows: the NIC only needs
    to know where to push.  Packets self-describe placement via a logical
    offset carried in the header.
    """
    base = [
        _f("qpn", 3, "addressing"),
        _f("dest_qpn", 3, "addressing"),
        _f("dest_ip", 4, "addressing"),
        _f("remote_base_va", 8, "addressing"),
        _f("rkey_compressed", 1, "addressing"),
        _f("state_flags", 1, "addressing"),
    ]
    assert _sum(base) == 20, _sum(base)
    return base + _DCQCN


def roce_context() -> List[Field]:
    """RoCE RC: go-back-N reliability, strict ordering, WQE cache. 407 B."""
    fields = list(_BASE_ADDRESSING) + list(_DCQCN) + [
        # reliability: go-back-N
        _f("sq_psn", 3, "reliability"),
        _f("rq_epsn", 3, "reliability"),
        _f("msn", 3, "reliability"),
        _f("last_acked_psn", 3, "reliability"),
        _f("retry_counter", 1, "reliability"),
        _f("rnr_retry_counter", 1, "reliability"),
        _f("retransmit_timer", 4, "reliability"),
        _f("rnr_timer", 2, "reliability"),
        _f("ack_timeout_cfg", 1, "reliability"),
        _f("outstanding_req_window", 16, "reliability"),
        # ordering
        _f("irrq_slots", 32, "ordering"),          # inbound RDMA read/atomic queue
        _f("orrq_slots", 48, "ordering"),          # outbound read request queue
        _f("reorder_head_tail", 8, "ordering"),
        # WQE cache + doorbells
        _f("sq_wqe_cache", 128, "wqe"),
        _f("rq_wqe_cache", 64, "wqe"),
        _f("sq_pi_ci", 8, "wqe"),
        _f("rq_pi_ci", 8, "wqe"),
        _f("cq_state", 8, "wqe"),
        _f("dma_scratch", 8, "wqe"),
    ]
    assert _sum(fields) == 407, _sum(fields)
    return fields


def irn_context() -> List[Field]:
    """IRN: selective repeat with per-packet bitmap tracking in NIC. 596 B."""
    fields = list(_BASE_ADDRESSING) + list(_DCQCN) + [
        # BDP-bounded windows + selective repeat state
        _f("sq_psn", 3, "reliability"),
        _f("rq_epsn", 3, "reliability"),
        _f("msn", 3, "reliability"),
        _f("last_acked_psn", 3, "reliability"),
        _f("recovery_psn", 3, "reliability"),
        _f("rto_timer", 4, "reliability"),
        _f("rto_low_timer", 4, "reliability"),
        _f("retry_counter", 1, "reliability"),
        # bitmaps (BDP-cap of packets tracked per QP)
        _f("tx_bitmap", 96, "reliability"),
        _f("rx_bitmap", 96, "reliability"),
        _f("sack_blocks", 32, "reliability"),
        # ordering / reassembly tracking
        _f("ooo_tracking", 58, "ordering"),
        _f("irrq_slots", 64, "ordering"),
        _f("reorder_head_tail", 8, "ordering"),
        # WQE cache + doorbells
        _f("sq_wqe_cache", 128, "wqe"),
        _f("sq_pi_ci", 8, "wqe"),
        _f("rq_pi_ci", 8, "wqe"),
        _f("cq_state", 8, "wqe"),
        _f("dma_scratch", 8, "wqe"),
    ]
    assert _sum(fields) == 596, _sum(fields)
    return fields


def srnic_context() -> List[Field]:
    """SRNIC: retransmission + reordering moved to host SW; no WQE cache.

    NIC keeps only what the fast path needs. 242 B.
    """
    fields = list(_BASE_ADDRESSING) + list(_DCQCN) + [
        _f("sq_psn", 3, "reliability"),
        _f("rq_epsn", 3, "reliability"),
        _f("msn", 3, "reliability"),
        _f("last_acked_psn", 3, "reliability"),
        _f("credit_state", 8, "reliability"),      # receiver-driven credits
        _f("slowpath_flag_epoch", 4, "reliability"),
        _f("ooo_metadata", 32, "ordering"),         # compact OOO summary for SW
        _f("sq_pi_ci", 8, "wqe"),
        _f("rq_pi_ci", 8, "wqe"),
        _f("cq_state", 8, "wqe"),
        _f("event_queue_state", 8, "wqe"),
        _f("doorbell_coalescing", 96, "wqe"),       # per-QP doorbell/batch state
    ]
    assert _sum(fields) == 242, _sum(fields)
    return fields


DESIGNS: Dict[str, List[Field]] = {
    "roce": roce_context(),
    "irn": irn_context(),
    "srnic": srnic_context(),
    "celeris": celeris_context(),
}

# Paper Table I published values (for validation).
PAPER_QP_BYTES: Dict[str, int] = {"roce": 407, "irn": 596, "srnic": 242, "celeris": 52}
PAPER_QP_SCALABILITY: Dict[str, int] = {
    "roce": 10_000, "irn": 8_000, "srnic": 20_000, "celeris": 80_000,
}


def qp_bytes(design: str) -> int:
    return _sum(DESIGNS[design])


def qp_capacity(design: str, sram_bytes: int = 4_160_000) -> int:
    """QPs supported by an SRAM budget (default ≈ Celeris@80K QPs)."""
    return sram_bytes // qp_bytes(design)


def category_breakdown(design: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in DESIGNS[design]:
        out[f.category] = out.get(f.category, 0) + f.bytes
    return out


def reliability_state_bytes(design: str) -> int:
    b = category_breakdown(design)
    return b.get("reliability", 0) + b.get("ordering", 0)


def table1() -> List[Tuple[str, int, int, int]]:
    """(design, per-QP bytes, reliability+ordering bytes, QPs @ budget)."""
    return [
        (d, qp_bytes(d), reliability_state_bytes(d), qp_capacity(d))
        for d in ("roce", "irn", "srnic", "celeris")
    ]
