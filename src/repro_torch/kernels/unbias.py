"""CUDA masked-unbias kernel wrapper (port of
``repro/kernels/unbias.py::masked_unbias_pallas``).

The kernel is ``csrc/unbias.cu``.  ``launches`` counts the kernel
launches made through :func:`masked_unbias_cuda`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.cache
def _launcher():
    fn = _build.load("unbias").unbias_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_unbias_cuda(y_sum: torch.Tensor, counts: torch.Tensor,
                       total: int) -> torch.Tensor:
    """``where(c > 0, y * total / max(c, 1), 0)`` with per-row counts.

    ``y_sum`` contiguous (rows, n) float32 or bfloat16 on CUDA, any n;
    ``counts`` contiguous (rows,) float32 on the same device.  Returns a
    new tensor in ``y_sum``'s dtype, computed on the current stream.
    """
    global launches
    if y_sum.device.type != "cuda":
        raise ValueError(
            f"masked_unbias_cuda needs a CUDA tensor, got {y_sum.device}")
    if y_sum.dtype not in _DTYPES:
        raise ValueError("masked_unbias_cuda takes float32 or bfloat16, got "
                         f"{y_sum.dtype}")
    if y_sum.dim() != 2 or not y_sum.is_contiguous():
        raise ValueError("masked_unbias_cuda takes a contiguous 2-D tensor, "
                         f"got shape {tuple(y_sum.shape)} "
                         f"strides {y_sum.stride()}")
    rows, n = y_sum.shape
    if (counts.device != y_sum.device or counts.dtype != torch.float32
            or counts.shape != (rows,) or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous float32 (rows,) tensor "
                         "on y_sum's device")
    out = torch.empty_like(y_sum)
    if out.numel() == 0:
        return out
    with torch.cuda.device(y_sum.device):
        err = _launcher()(
            y_sum.data_ptr(), counts.data_ptr(), out.data_ptr(), rows, n,
            float(total), _DTYPES[y_sum.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"unbias kernel launch failed: cudaError {err}")
    launches += 1
    return out
