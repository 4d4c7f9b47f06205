"""Plain PyTorch versions of the port's CUDA kernels (port of
``repro/kernels/ref.py``): FWHT, int8 quantize, the fused pair, and
masked unbias.

Each computes the same function as its kernel, in the same float32
operation order, so on identical inputs kernel and plain version agree
bit for bit.  The CPU path of :mod:`repro_torch.kernels.ops` runs these;
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sylvester Hadamard matrix H_n (unnormalized, entries +-1)."""
    assert _is_pow2(n), n
    h = torch.ones((1, 1), dtype=dtype, device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h


def fwht(x: torch.Tensor, *, signs: Optional[torch.Tensor] = None,
         scale: float = 1.0) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along the last axis.

    Equivalent to ``(x * signs) @ hadamard_matrix(n) * scale``.  The
    butterfly runs in float32 (the kernel's accumulation type) and the
    result is cast back to ``x``'s dtype, as the Pallas kernel does.
    """
    n = x.shape[-1]
    assert _is_pow2(n), n
    orig_shape = x.shape
    y = x.reshape(-1, n).to(torch.float32)
    if signs is not None:
        y = y * signs.to(torch.float32)[None, :]
    m = 1
    while m < n:
        y = y.reshape(-1, n // (2 * m), 2, m)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2).reshape(-1, n)
        m *= 2
    if scale != 1.0:
        y = y * scale
    return y.to(x.dtype).reshape(orig_shape)


def quantize_int8(x: torch.Tensor, noise: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 stochastic quantization.

    ``noise`` is uniform [0, 1) with ``x``'s shape, supplied by the
    caller so that kernel and plain version consume identical bits.
    Returns (q int8, scale float32 per row).
    """
    x = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # both divisions by tensors: a Python scalar divisor is taken as a
    # multiply by its reciprocal on the card, not the IEEE quotient
    scale = torch.where(absmax > 0,
                        torch.div(absmax, torch.full_like(absmax, 127.0)),
                        1.0)
    q = torch.floor(torch.div(x, scale) + noise.to(torch.float32))
    q = torch.clamp(q, -127.0, 127.0).to(torch.int8)
    return q, scale[..., 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def fwht_quantize(x: torch.Tensor, noise: torch.Tensor, *,
                  signs: Optional[torch.Tensor] = None,
                  scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_int8(fwht(x, signs=..., scale=...), noise)``: the
    rotation of a float32 tile, then its per-row int8 quantization."""
    return quantize_int8(fwht(x.to(torch.float32), signs=signs, scale=scale),
                         noise)


def masked_unbias(y_sum: torch.Tensor, counts: torch.Tensor,
                  total: int) -> torch.Tensor:
    """Decode-side unbiasing: received sums times total/count (0 if none).

    ``y_sum``  (rows, n): summed received contributions.
    ``counts`` (rows,): how many contributions arrived.
    The product is taken in float32 and cast to ``y_sum``'s dtype.
    """
    c = counts.to(torch.float32)[:, None]
    safe = torch.clamp(c, min=1.0)
    # torch.div, not ``total / safe``: the reflected operator multiplies
    # by the reciprocal, which is not the IEEE quotient the kernel takes
    factor = torch.div(float(total), safe)
    out = torch.where(c > 0, y_sum.to(torch.float32) * factor, 0.0)
    return out.to(y_sum.dtype)
