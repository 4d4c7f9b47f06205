"""ML-pipeline loss recovery (port of ``repro/core/coding.py``, the
randomized Hadamard code).

**Randomized Hadamard rotation**:
    encode:  y = (1/sqrt(n)) H D x     per rotation block of width n
    decode:  x_hat = (n/k) (1/sqrt(n)) D H S y   (S = arrival mask, k = |S|)
  exactly unbiased (E[x_hat] = x) and lossless when k = n.

**Wire interleaving**: after rotating each (B, n) block-row the payload
is transposed to (n, B) "wire layout", so network chunk j carries
coordinate j of *every* rotation block and a lost chunk removes a 1/n
coordinate slice from each block.

The transforms run through :mod:`repro_torch.kernels.ops`: the CUDA
kernels on the card, the plain versions on the CPU.  Those kernels take
contiguous rows, so both transposes are materialized here with
``.contiguous()``; the wire layout is a real memory layout anyway.

XOR parity and the ND (tiled) forms arrive with the training slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class HadamardCode:
    """Static coding geometry for one flat payload."""
    n_rot: int          # rotation block width (power of two)
    n_blocks: int       # rotation blocks (padded_len = n_rot * n_blocks)
    orig_len: int       # unpadded payload length

    @property
    def padded_len(self) -> int:
        return self.n_rot * self.n_blocks

    @property
    def wire_shape(self) -> tuple[int, int]:
        """(n_rot, n_blocks): wire row j = coordinate j of every block."""
        return (self.n_rot, self.n_blocks)


def plan(orig_len: int, n_rot: int = 4096) -> HadamardCode:
    """Widest rotation block up to ``n_rot`` that the payload fills.

    The JAX ``block_multiple`` (shard alignment for the trainer) comes
    with the training slice."""
    while n_rot > 1 and n_rot > orig_len:
        n_rot //= 2
    n_rot = max(n_rot, 2)
    n_blocks = -(-orig_len // n_rot)
    return HadamardCode(n_rot=n_rot, n_blocks=n_blocks, orig_len=orig_len)


def rademacher(generator: torch.Generator, code: HadamardCode) -> torch.Tensor:
    """Random sign diagonal D (n_rot,) float32, on the generator's device.

    One vector shared across rotation blocks; every participant draws it
    from an identically seeded generator.
    """
    bits = torch.randint(0, 2, (code.n_rot,), generator=generator,
                         device=generator.device)
    return bits.to(torch.float32) * 2 - 1


def _blocks(x: torch.Tensor, code: HadamardCode) -> torch.Tensor:
    x = F.pad(x.reshape(-1), (0, code.padded_len - code.orig_len))
    return x.reshape(code.n_blocks, code.n_rot)


def encode(x: torch.Tensor, signs: torch.Tensor, code: HadamardCode
           ) -> torch.Tensor:
    """flat (orig_len,) -> contiguous wire layout (n_rot, n_blocks)."""
    # sign-multiply + 1/sqrt(n) normalization fused into the kernel
    rot = ops.fwht(_blocks(x, code), signs=signs, scale=code.n_rot ** -0.5)
    return rot.T.contiguous()


def decode(wire_sum: torch.Tensor, counts: torch.Tensor, signs: torch.Tensor,
           code: HadamardCode, *, total_peers: int = 1) -> torch.Tensor:
    """Inverse of :func:`encode` over *summed received* wire data.

    ``wire_sum`` (n_rot, n_blocks): per-wire-row sums of the
    contributions that arrived.  ``counts`` (n_rot,) float32: how many of
    the ``total_peers`` expected contributions arrived per row.

    Two unbiasing stages, both no-ops when nothing was lost:
      1. peer unbias: row r scaled by total_peers/counts[r];
      2. sampling unbias: every present row scaled by n_rot/k
         (k = rows with any arrival).  ``k`` stays a device tensor, so
         decoding does not wait on the device.
    """
    row_est = ops.masked_unbias(wire_sum.contiguous(), counts,
                                total_peers)                   # stage 1
    k = (counts > 0).sum()
    scale = torch.where(k > 0, torch.div(code.n_rot, k.clamp(min=1)), 0.0)
    rot = row_est.T.contiguous()
    rot.mul_(scale)                                            # stage 2
    blocks = ops.fwht(rot, scale=code.n_rot ** -0.5) * signs[None, :]
    return blocks.reshape(-1)[: code.orig_len]
