"""CUDA FWHT kernel wrapper (port of ``repro/kernels/fwht.py::fwht_pallas``).

The kernel is ``csrc/fwht.cu``; its source note says what bounds it and
how its design answers.  ``launches`` counts the kernel launches made
through :func:`fwht_cuda`, so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_N = 4096          # the kernel's shared-memory tile holds one such row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.cache
def _launcher():
    fn = _build.load("fwht").fwht_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fwht_cuda(x: torch.Tensor, signs: Optional[torch.Tensor] = None,
              scale: float = 1.0) -> torch.Tensor:
    """FWHT along the last axis of a contiguous (rows, n) CUDA tensor.

    ``x`` float32 or bfloat16, n a power of two in [2, 4096]; ``signs``
    (n,) float32 on the same device or None.  Returns a new tensor in
    ``x``'s dtype, computed on the current stream.
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fwht_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fwht_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fwht_cuda takes a contiguous 2-D tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    rows, n = x.shape
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(f"n must be a power of two in [2, {MAX_N}], got {n}")
    if signs is not None and (signs.device != x.device
                              or signs.dtype != torch.float32
                              or signs.shape != (n,)
                              or not signs.is_contiguous()):
        raise ValueError("signs must be a contiguous float32 (n,) tensor on "
                         "x's device")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), out.data_ptr(),
            None if signs is None else signs.data_ptr(),
            rows, n.bit_length() - 1, float(scale), _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fwht kernel launch failed: cudaError {err}")
    launches += 1
    return out
