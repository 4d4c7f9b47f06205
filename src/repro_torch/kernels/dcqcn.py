"""CUDA DCQCN scan kernel wrapper (replaces the JAX engine's
``lax.scan``, ``repro/core/transport/engine_jax.py::_dcqcn_scan``; the
JAX package has no Pallas kernel for it).

The kernels are ``csrc/dcqcn.cu``: one call launches three (the
compaction of the active steps, the walk over them, the calm fill).
``launches`` counts the calls made through :func:`dcqcn_scan_cuda`: one
per engine block.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

# dcqcn_scan_launch's arguments: 11 pointers, (S, tb, n), the five float
# parameters, hyper_after, then the workspace and the stream
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 3
                   + [ctypes.c_double] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)


def bind(lib: ctypes.CDLL):
    """The C entry points of a built ``dcqcn.cu``, ``(launch,
    workspace_bytes)``, with their argument types set."""
    fn = lib.dcqcn_scan_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    ws = lib.dcqcn_scan_workspace_bytes
    ws.argtypes = [ctypes.c_longlong] * 3
    ws.restype = ctypes.c_longlong
    return fn, ws


@functools.cache
def _launchers():
    return bind(_build.load("dcqcn"))


def _check(name, t, dtype, shape, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"dcqcn_scan_cuda: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def dcqcn_scan_cuda(cnp: torch.Tensor, any_t: torch.Tensor,
                    rate: torch.Tensor, target: torch.Tensor,
                    alpha: torch.Tensor, good: torch.Tensor, dq):
    """The DCQCN recurrence over a block of ``tb`` steps.

    ``cnp`` bool (S, tb, n) CNP marks; ``any_t`` bool (S, tb), true where
    any flow of the seed is marked; the carried state ``rate``,
    ``target``, ``alpha`` float64 (S, n) and ``good`` int32 (S, n), all
    contiguous on one CUDA device; ``dq`` the ``DcqcnParams``.  Returns
    ``(rates float32 (S, tb, n), (rate, target, alpha, good))``, the new
    state in new tensors, computed on the current stream.
    """
    global launches
    if cnp.device.type != "cuda":
        raise ValueError(f"dcqcn_scan_cuda needs CUDA tensors, got "
                         f"{cnp.device}")
    if cnp.dim() != 3:
        raise ValueError(f"cnp must be (S, tb, n), got {tuple(cnp.shape)}")
    S, tb, n = cnp.shape
    dev = cnp.device
    _check("cnp", cnp, torch.bool, (S, tb, n), dev)
    _check("any_t", any_t, torch.bool, (S, tb), dev)
    for name, t in (("rate", rate), ("target", target), ("alpha", alpha)):
        _check(name, t, torch.float64, (S, n), dev)
    _check("good", good, torch.int32, (S, n), dev)
    rates = torch.empty((S, tb, n), dtype=torch.float32, device=dev)
    state = tuple(torch.empty_like(t) for t in (rate, target, alpha, good))
    if S == 0 or n == 0:
        return rates, state
    launch, ws_bytes = _launchers()
    # the active-step lists, gap pows and calm-gap anchors, which
    # csrc/dcqcn.cu carves from one 256-byte aligned block
    work = torch.empty(ws_bytes(S, tb, n), dtype=torch.uint8, device=dev)
    if work.data_ptr() % 256:
        raise RuntimeError("dcqcn_scan_cuda: workspace not 256-byte aligned")
    with torch.cuda.device(dev):
        err = launch(
            cnp.data_ptr(), any_t.data_ptr(), rate.data_ptr(),
            target.data_ptr(), alpha.data_ptr(), good.data_ptr(),
            rates.data_ptr(), *(t.data_ptr() for t in state), S, tb, n,
            dq.alpha_g, dq.rate_decrease_floor, dq.additive_increase,
            dq.hyper_increase, dq.min_rate, dq.hyper_after, work.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dcqcn kernel launch failed: cudaError {err}")
    launches += 1
    return rates, state
