"""Dispatch between the CUDA kernels and their plain versions (port of
``repro/kernels/ops.py``).

A tensor on the CPU takes the plain PyTorch version in :mod:`ref`; any
other tensor goes to the kernel, which launches on CUDA or raises.  No
row padding is needed (the JAX ``_pad_rows``): the kernels mask their
ragged edges themselves.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dcqcn as _dcqcn
from repro_torch.kernels import fwht as _fwht
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import ref
from repro_torch.kernels import unbias as _unbias


def fwht(x: torch.Tensor, *, signs: Optional[torch.Tensor] = None,
         scale: float = 1.0) -> torch.Tensor:
    """FWHT along the last axis of a 2-D tensor (unnormalized by default).

    ``signs`` (n,) and ``scale`` fuse the Rademacher pre-multiply and
    the normalization into the kernel.  The result has ``x``'s dtype;
    the transform runs in float32.
    """
    if x.device.type == "cpu":
        return ref.fwht(x, signs=signs, scale=scale)
    return _fwht.fwht_cuda(x, signs, scale)


def fwht_quantize(x: torch.Tensor, noise: torch.Tensor, *,
                  signs: Optional[torch.Tensor] = None,
                  scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused rotate-then-quantize of a float32 (rows, n) tensor: the FWHT
    output feeds the per-row absmax int8 quantizer without a round trip
    through device memory (what ``coding.encode_quantized`` issues).
    The same function as ``quantize_int8(fwht(x, signs=..., scale=...),
    noise)``.  Returns (q int8, scale float32 per row).
    """
    if x.device.type == "cpu":
        return ref.fwht_quantize(x, noise, signs=signs, scale=scale)
    return _fwht.fwht_quantize_cuda(x, noise, signs, scale)


def quantize_int8(x: torch.Tensor, noise: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return ref.quantize_int8(x, noise)
    return _quant.quantize_int8_cuda(x, noise)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return ref.dequantize_int8(q, scale)


def masked_unbias(y_sum: torch.Tensor, counts: torch.Tensor,
                  total: int) -> torch.Tensor:
    if y_sum.device.type == "cpu":
        return ref.masked_unbias(y_sum, counts, total)
    return _unbias.masked_unbias_cuda(y_sum, counts, total)


def dcqcn_scan(cnp: torch.Tensor, any_t: torch.Tensor, rate: torch.Tensor,
               target: torch.Tensor, alpha: torch.Tensor, good: torch.Tensor,
               dq):
    """The DCQCN recurrence over a block of engine steps: ``cnp`` bool
    (S, tb, n), ``any_t`` bool (S, tb), the carried state float64 (S, n)
    and ``good`` int32 (S, n).  Returns ``(rates float32 (S, tb, n),
    (rate, target, alpha, good))``."""
    if cnp.device.type == "cpu":
        return ref.dcqcn_scan(cnp, any_t, rate, target, alpha, good, dq)
    return _dcqcn.dcqcn_scan_cuda(cnp, any_t, rate, target, alpha, good, dq)
