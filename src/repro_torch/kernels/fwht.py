"""CUDA FWHT kernel wrappers (port of ``repro/kernels/fwht.py``:
``fwht_pallas`` and ``fwht_quantize_pallas``).

Both kernels are in ``csrc/fwht.cu``; its source note says what bounds
them and how the design answers.  ``launches`` counts the FWHT launches
made through :func:`fwht_cuda` and ``quantize_launches`` the fused
launches made through :func:`fwht_quantize_cuda`, so a run can show it
went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quantize as _quant

MAX_N = 4096          # a block's tile of 4096 elements holds one such row
ALIGN = 16            # bytes: the kernels move 16-byte vectors
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
quantize_launches = 0


def bind(lib: ctypes.CDLL):
    """The two C entry points of a built ``fwht.cu``, ``(fwht_launch,
    fwht_quantize_launch)``, with their argument types set."""
    fn = lib.fwht_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fq = lib.fwht_quantize_launch
    fq.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fq.restype = ctypes.c_int
    return fn, fq


@functools.cache
def _launchers():
    return bind(_build.load("fwht"))


def _check_signs(x: torch.Tensor, signs: Optional[torch.Tensor],
                 n: int) -> None:
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(f"n must be a power of two in [2, {MAX_N}], got {n}")
    if signs is not None and (signs.device != x.device
                              or signs.dtype != torch.float32
                              or signs.shape != (n,)
                              or not signs.is_contiguous()):
        raise ValueError("signs must be a contiguous float32 (n,) tensor on "
                         "x's device")


def check_aligned(name: str, **tensors: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless each given tensor starts on an
    ``ALIGN``-byte boundary: the kernels load and store 16-byte vectors
    and take no scalar path.  A contiguous view such as ``t[1:]`` of a
    fresh tensor may not."""
    for what, t in tensors.items():
        if t is not None and t.data_ptr() % ALIGN:
            raise ValueError(
                f"{name}: {what} must start on a {ALIGN}-byte boundary, got "
                f"data_ptr {t.data_ptr():#x}")


def fwht_cuda(x: torch.Tensor, signs: Optional[torch.Tensor] = None,
              scale: float = 1.0) -> torch.Tensor:
    """FWHT along the last axis of a contiguous (rows, n) CUDA tensor.

    ``x`` float32 or bfloat16, n a power of two in [2, 4096]; ``signs``
    (n,) float32 on the same device or None; both 16-byte aligned.
    Returns a new tensor in ``x``'s dtype, computed on the current
    stream.
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
    _check_signs(x, signs, n)
    check_aligned("fwht_cuda", x=x, signs=signs)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        err = _launchers()[0](
            x.data_ptr(), out.data_ptr(),
            None if signs is None else signs.data_ptr(),
            rows, n.bit_length() - 1, float(scale), _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fwht kernel launch failed: cudaError {err}")
    launches += 1
    return out


def fwht_quantize_cuda(x: torch.Tensor, noise: torch.Tensor,
                       signs: Optional[torch.Tensor] = None,
                       scale: float = 1.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused FWHT + per-row absmax int8 quantization of a contiguous
    (rows, n) float32 CUDA tensor, n a power of two in [2, 4096];
    ``noise`` uniform [0, 1) of the same shape; x, noise and signs
    16-byte aligned.  Returns (q int8 (rows, n), scale float32 (rows,)),
    computed on the current stream."""
    global quantize_launches
    _quant.check_noise(x, noise, "fwht_quantize_cuda")
    rows, n = x.shape
    _check_signs(x, signs, n)
    check_aligned("fwht_quantize_cuda", x=x, noise=noise, signs=signs)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scales
    with torch.cuda.device(x.device):
        err = _launchers()[1](
            x.data_ptr(), noise.data_ptr(),
            None if signs is None else signs.data_ptr(), q.data_ptr(),
            scales.data_ptr(), rows, n.bit_length() - 1, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fwht_quantize kernel launch failed: cudaError {err}")
    quantize_launches += 1
    return q, scales
