"""Dispatch between the CUDA kernels and their plain versions (port of
``repro/kernels/ops.py``).

A tensor on the CPU takes the plain PyTorch version in :mod:`ref`; any
other tensor goes to the kernel, which launches on CUDA or raises.  No
row padding is needed (the JAX ``_pad_rows``): the kernels mask their
ragged edges themselves.

The FWHT, the fused FWHT + quantize, the quantizer and the unbias are
``torch.library`` custom ops (``torch.ops.repro_torch.*``): their CUDA
implementation is the kernel's launcher, and each has a fake
implementation that returns empty outputs of the right shapes and
dtypes, so a step traced on meta tensors (``launch/dryrun.py``) passes
through them.  The fake computes nothing and only meta (or fake) tensors
reach it; a CUDA tensor launches the kernel or raises.  The DCQCN scan is
no custom op: the engine that runs it is on no traced path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dcqcn as _dcqcn
from repro_torch.kernels import fwht as _fwht
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import ref
from repro_torch.kernels import unbias as _unbias


@torch.library.custom_op("repro_torch::fwht", mutates_args=(),
                        device_types="cuda")
def _fwht_op(x: torch.Tensor, signs: Optional[torch.Tensor],
             scale: float) -> torch.Tensor:
    return _fwht.fwht_cuda(x, signs, scale)


@_fwht_op.register_fake
def _(x, signs, scale):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::fwht_quantize", mutates_args=(),
                        device_types="cuda")
def _fwht_quantize_op(x: torch.Tensor, noise: torch.Tensor,
                      signs: Optional[torch.Tensor], scale: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    return _fwht.fwht_quantize_cuda(x, noise, signs, scale)


def _quantized_like(x: torch.Tensor, *_):
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty(x.shape[:1], dtype=torch.float32, device=x.device))


_fwht_quantize_op.register_fake(_quantized_like)


@torch.library.custom_op("repro_torch::quantize_int8", mutates_args=(),
                        device_types="cuda")
def _quantize_op(x: torch.Tensor, noise: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    return _quant.quantize_int8_cuda(x, noise)


_quantize_op.register_fake(_quantized_like)


@torch.library.custom_op("repro_torch::masked_unbias", mutates_args=(),
                        device_types="cuda")
def _unbias_op(y_sum: torch.Tensor, counts: torch.Tensor,
               total: float) -> torch.Tensor:
    return _unbias.masked_unbias_cuda(y_sum, counts, total)


@_unbias_op.register_fake
def _(y_sum, counts, total):
    return torch.empty_like(y_sum)


def fwht(x: torch.Tensor, *, signs: Optional[torch.Tensor] = None,
         scale: float = 1.0) -> torch.Tensor:
    """FWHT along the last axis of a 2-D tensor (unnormalized by default).

    ``signs`` (n,) and ``scale`` fuse the Rademacher pre-multiply and
    the normalization into the kernel.  The result has ``x``'s dtype;
    the transform runs in float32.
    """
    if x.device.type == "cpu":
        return ref.fwht(x, signs=signs, scale=scale)
    return _fwht_op(x, signs, float(scale))


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
    return _fwht_quantize_op(x, noise, signs, float(scale))


def quantize_int8(x: torch.Tensor, noise: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return ref.quantize_int8(x, noise)
    return _quantize_op(x, noise)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return ref.dequantize_int8(q, scale)


def masked_unbias(y_sum: torch.Tensor, counts: torch.Tensor,
                  total: int) -> torch.Tensor:
    if y_sum.device.type == "cpu":
        return ref.masked_unbias(y_sum, counts, total)
    return _unbias_op(y_sum, counts, float(total))


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
