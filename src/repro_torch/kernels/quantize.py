"""CUDA int8 quantize kernel wrapper (port of
``repro/kernels/quantize.py::quantize_int8_pallas``).

The kernel is ``csrc/quantize.cu``.  ``launches`` counts the kernel
launches made through :func:`quantize_int8_cuda`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0


@functools.cache
def _launcher():
    fn = _build.load("quantize").quantize_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_noise(x: torch.Tensor, noise: torch.Tensor, name: str) -> None:
    """The operand checks the quantizing kernels share."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    for t, what in ((x, "x"), (noise, "noise")):
        if (t.dtype != torch.float32 or t.dim() != 2
                or not t.is_contiguous()):
            raise ValueError(f"{name} takes a contiguous 2-D float32 {what}, "
                             f"got {t.dtype} shape {tuple(t.shape)}")
    if noise.shape != x.shape or noise.device != x.device:
        raise ValueError("noise must have x's shape and device")


def quantize_int8_cuda(x: torch.Tensor, noise: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 stochastic quantization of a contiguous
    (rows, n) float32 CUDA tensor, any n; ``noise`` uniform [0, 1) of the
    same shape.  Returns (q int8 (rows, n), scale float32 (rows,)),
    computed on the current stream."""
    global launches
    check_noise(x, noise, "quantize_int8_cuda")
    rows, n = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return q, scales
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), noise.data_ptr(), q.data_ptr(),
                          scales.data_ptr(), rows, n,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    launches += 1
    return q, scales
