"""Static cost analysis of one rank's program (port of
``repro/launch/costs.py``).

The JAX package walks a traced jaxpr (``jaxpr_costs``) and parses the
compiled post-SPMD HLO for collectives (``hlo_collective_bytes``).  The
port runs the rank's program eagerly on meta tensors under
:class:`CostMode`, a ``TorchDispatchMode`` that sees every aten and
``c10d`` op the rank issues, backward and remat recompute included, and
counts:

- **FLOPs**: 2·M·N·K for the matmul family (``torch.utils.flop_counter``'s
  formulas: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, the attention
  kernels), plus one an element for the transcendental ops JAX counts
  (``costs.py:119-122``: exp, tanh, log, logistic, erf, rsqrt, sin, cos,
  pow, and the torch ops that hold one: silu, gelu, softmax);
- **HBM bytes** by JAX's rule (``costs.py:67-69``, ``:116-118``): a
  matmul's operands and output in full, any other op's outputs times 0.5
  (a fusion discount); a view moves nothing;
- **collectives**: count and bytes of each kind a rank, its result's
  bytes as the HLO parse takes them;
- **peak live bytes**: the storage bytes alive at once, every tensor the
  program touches counted from the first time it is seen until it is
  freed (the counterpart of ``memory_analysis``).

Every count is one rank's: multiply by the ranks for the global FLOPs.
:func:`roofline` turns them into times on the card's constants
(:data:`HW`); JAX's table is a TPU v5e's and is not carried over.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# One NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit.
HW = {
    # NVIDIA H100 data sheet, SXM part, dense bf16 (no sparsity)
    "peak_flops_bf16": 989e12,
    # the same data sheet: 80 GB of HBM3 at 3.35 TB/s
    "hbm_bw": 3.35e12,
    "hbm_bytes": 80e9,
    # the network a rank of a multi-node mesh sends on: one 400 Gb/s
    # NDR InfiniBand port a GPU, the DGX H100 layout (NVIDIA DGX H100
    # user guide); a 16 x 16 mesh's model groups span two 8-GPU nodes
    "net_bw": 50e9,
}
CARD = "NVIDIA H100 80GB HBM3, 700 W"

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "tanh", "log", "log1p", "log2",
                   "sigmoid", "erf", "rsqrt", "sin", "cos", "pow", "silu",
                   "gelu", "_softmax", "_log_softmax", "softplus"}
_COLLECTIVES = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather",
    "scatter_": "scatter", "send": "send", "recv_": "recv",
    "recv_any_source_": "recv", "barrier": "barrier",
}


def _tensors(tree, out=None):
    """The tensors in ``tree`` (tensors, or lists, tuples and dicts of
    them, as op arguments and results are)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class CostMode(TorchDispatchMode):
    """Counts FLOPs, HBM bytes, collectives and live storage over the ops
    dispatched inside it (see the module's docstring).  ``costs()``
    gives the counts."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0.0
        self.transcendental_flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:
            self._see(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._see(t)
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "c10d":
            kind = _COLLECTIVES.get(name, name)
            rec = self.collectives.setdefault(kind,
                                              {"count": 0, "bytes": 0})
            # in-place collectives return their (output) buffers
            buf = sum(_nbytes(t) for t in (outs or ins))
            rec["count"] += 1
            rec["bytes"] += buf
            self.hbm_bytes += sum(_nbytes(t) for t in ins)
        elif packet in flop_registry:
            self.matmul_flops += flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        elif not _is_view(func):
            self.hbm_bytes += 0.5 * sum(_nbytes(t) for t in outs)
            if name in _TRANSCENDENTAL:
                self.transcendental_flops += sum(t.numel() for t in outs)
        return out

    def costs(self) -> Dict[str, object]:
        """{flops, matmul_flops, transcendental_flops, hbm_bytes,
        collectives: {kind: {count, bytes}}, coll_bytes, peak_bytes}, one
        rank's."""
        return {"flops": self.matmul_flops + self.transcendental_flops,
                "matmul_flops": self.matmul_flops,
                "transcendental_flops": self.transcendental_flops,
                "hbm_bytes": self.hbm_bytes,
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items()},
                "coll_bytes": float(sum(v["bytes"] for v in
                                        self.collectives.values())),
                "peak_bytes": self.peak_bytes}


def trace_costs(fn, *args, **kwargs) -> Dict[str, object]:
    """:meth:`CostMode.costs` of the call ``fn(*args, **kwargs)``."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.costs()


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             n_ranks: int, model_flops: float,
             hw: Dict[str, float] = HW) -> Dict[str, object]:
    """JAX's roofline terms from one rank's counts: compute, memory and
    collective seconds on the card's constants, the dominant term,
    ``model_flops`` (the whole mesh's useful FLOPs) over the mesh's
    counted FLOPs, and the compute term's share of the largest."""
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = hbm_bytes / hw["hbm_bw"]
    coll_s = coll_bytes / hw["net_bw"]
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / max(flops * n_ranks, 1.0),
        "roofline_frac": max(compute_s, 1e-30)
        / max(compute_s, memory_s, coll_s),
        "card": CARD,
    }
