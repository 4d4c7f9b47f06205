"""ML-pipeline loss recovery (port of ``repro/core/coding.py``: the
randomized Hadamard code, its int8 wire, XOR parity, and the tiled ND
form the trainer uses).

**Randomized Hadamard rotation**:
    encode:  y = (1/sqrt(n)) H D x     per rotation block of width n
    decode:  x_hat = (n/k) (1/sqrt(n)) D H S y   (S = arrival mask, k = |S|)
  exactly unbiased (E[x_hat] = x) and lossless when k = n.

**Wire interleaving**: after rotating each (B, n) block-row the payload
is transposed to (n, B) "wire layout", so network chunk j carries
coordinate j of *every* rotation block and a lost chunk removes a 1/n
coordinate slice from each block.

**Int8 wire**: :func:`encode_quantized` rotates and quantizes each
rotation block to absmax-scaled int8 in one fused kernel;
:func:`dequantize_wire` restores the float32 wire layout.

**XOR parity**: exact recovery of any single lost chunk per parity
group.

**ND form** (:func:`plan_nd`, :func:`encode_nd`, :func:`decode_nd`):
each gradient leaf is tiled as (tiles, n_rot, Ns) and rotated along its
middle axis.  The JAX package rotates with a jnp butterfly there to keep
GSPMD from resharding; here the tiles are laid out as contiguous
(tiles*Ns, n_rot) rows and go through the FWHT kernel.

The transforms run through :mod:`repro_torch.kernels.ops`: the CUDA
kernels on the card, the plain versions on the CPU.  Those kernels take
contiguous rows, so both transposes are materialized here with
``.contiguous()``; the wire layout is a real memory layout anyway.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

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


def plan(orig_len: int, n_rot: int = 4096, block_multiple: int = 1
         ) -> HadamardCode:
    """Widest rotation block up to ``n_rot`` that the payload fills;
    ``block_multiple`` rounds the block count up (the JAX trainer's shard
    alignment over the model axis)."""
    while n_rot > 1 and n_rot > orig_len:
        n_rot //= 2
    n_rot = max(n_rot, 2)
    n_blocks = -(-orig_len // n_rot)
    n_blocks = -(-n_blocks // block_multiple) * block_multiple
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


def encode_quantized(x: torch.Tensor, signs: torch.Tensor, code: HadamardCode,
                     generator: Optional[torch.Generator] = None, *,
                     noise: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`encode` with the wire payload quantized to int8.

    Per rotation block the rotated coordinates are stochastically
    rounded to absmax-scaled int8, a 4x cut in wire bytes; rotate and
    quantize run as one fused kernel (``ops.fwht_quantize``).  The
    uniform [0, 1) rounding noise, (n_blocks, n_rot) float32, is drawn
    from ``generator`` or passed in as ``noise``.

    Returns (q_wire (n_rot, n_blocks) int8, contiguous; scales
    (n_blocks,) float32).
    """
    blocks = _blocks(x.to(torch.float32), code)
    if noise is None:
        if generator is None:
            raise ValueError("encode_quantized needs a generator or noise")
        noise = torch.rand(blocks.shape, generator=generator,
                           device=blocks.device)
    q, scales = ops.fwht_quantize(blocks, noise, signs=signs,
                                  scale=code.n_rot ** -0.5)
    return q.T.contiguous(), scales


def dequantize_wire(q_wire: torch.Tensor, scales: torch.Tensor
                    ) -> torch.Tensor:
    """int8 wire layout (n_rot, n_blocks) -> float32 wire layout."""
    return q_wire.to(torch.float32) * scales[None, :]


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


# ----------------------------------------------------------------------
# XOR parity (exact single-loss recovery per group)
# ----------------------------------------------------------------------

def _xor_rows(bits: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of a (g, m) int32 tensor."""
    return functools.reduce(torch.bitwise_xor, bits.unbind(0),
                            torch.zeros_like(bits[0]))


def xor_parity_encode(chunks: torch.Tensor) -> torch.Tensor:
    """chunks (g, m) float32 -> parity chunk (m,) via bitwise XOR."""
    return _xor_rows(chunks.contiguous().view(torch.int32)).view(
        torch.float32)


def xor_parity_decode(chunks: torch.Tensor, parity: torch.Tensor,
                      arrived: torch.Tensor) -> torch.Tensor:
    """Recover at most one lost chunk in the group.

    ``chunks`` (g, m) float32 with lost rows zeroed, ``arrived`` (g,)
    bool.  Exactly one lost row is rebuilt bit for bit; with none the
    input comes back unchanged; with more the lost rows stay zero.
    """
    n_lost = (~arrived).sum()
    bits = chunks.contiguous().view(torch.int32)
    # rows zeroed by a mask can hold -0.0 (sign bit set): scrub them so a
    # lost row adds no bits to the XOR
    bits = torch.where(arrived[:, None], bits, 0)
    recovered = torch.bitwise_xor(_xor_rows(bits),
                                  parity.contiguous().view(torch.int32))
    rec_f = recovered.view(torch.float32)
    fill = torch.where((n_lost == 1) & ~arrived[:, None], rec_f[None, :],
                       0.0)
    return torch.where(arrived[:, None], chunks, fill)


# ----------------------------------------------------------------------
# Flatten a list of tensors (the JAX leaf view) into one float32 payload
# ----------------------------------------------------------------------

def tree_ravel(leaves: Sequence[torch.Tensor]
               ) -> tuple[torch.Tensor, list]:
    """Tensors -> (flat float32 vector, spec for :func:`tree_unravel`)."""
    vec = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])
    return vec, [(tuple(l.shape), l.dtype) for l in leaves]


def tree_unravel(vec: torch.Tensor, spec: list) -> list:
    out, off = [], 0
    for shape, dtype in spec:
        size = math.prod(shape)
        out.append(vec[off: off + size].reshape(shape).to(dtype))
        off += size
    return out


# ----------------------------------------------------------------------
# ND (tiled) coding, the form the trainer uses
# ----------------------------------------------------------------------
#
# A leaf's sharded dim (if any) moves to the end; the other dims flatten
# into tiles of n_rot, and the rotation runs along the middle axis of
# (tiles, n_rot, Ns).  On one device every leaf has Ns == 1.

@dataclasses.dataclass(frozen=True)
class NdPlan:
    n_rot: int
    tiles: int          # flattened-unsharded length = tiles * n_rot (padded)
    sharded_dim: Optional[int]
    shape: tuple        # original leaf shape
    m_orig: int         # unpadded flattened-unsharded length


def rademacher_nd(generator: torch.Generator, plan: NdPlan) -> torch.Tensor:
    bits = torch.randint(0, 2, (plan.n_rot,), generator=generator,
                         device=generator.device)
    return bits.to(torch.float32) * 2 - 1


def plan_nd(shape: Sequence[int], sharded_dim: Optional[int],
            n_rot: int = 4096) -> NdPlan:
    m = math.prod(d for i, d in enumerate(shape) if i != sharded_dim)
    while n_rot > 1 and n_rot > m:
        n_rot //= 2
    n_rot = max(n_rot, 2)
    tiles = -(-m // n_rot)
    return NdPlan(n_rot=n_rot, tiles=tiles, sharded_dim=sharded_dim,
                  shape=tuple(shape), m_orig=m)


def to_tiles_nd(g: torch.Tensor, plan: NdPlan) -> torch.Tensor:
    """leaf -> (tiles, n_rot, Ns).  The tile layout without rotation:
    the plain-lossy path drops wire rows straight out of it."""
    sd = plan.sharded_dim
    if sd is not None:
        perm = [i for i in range(g.dim()) if i != sd] + [sd]
        g = g.permute(perm)
        ns = g.shape[-1]
        g = g.reshape(-1, ns)
    else:
        g = g.reshape(-1, 1)
        ns = 1
    pad = plan.tiles * plan.n_rot - plan.m_orig
    if pad:
        g = F.pad(g, (0, 0, 0, pad))
    return g.reshape(plan.tiles, plan.n_rot, ns)


def from_tiles_nd(t: torch.Tensor, plan: NdPlan) -> torch.Tensor:
    sd = plan.sharded_dim
    ns = t.shape[-1]
    g = t.reshape(-1, ns)[: plan.m_orig]
    if sd is None:
        return g.reshape(plan.shape)
    rest = [d for i, d in enumerate(plan.shape) if i != sd]
    g = g.reshape(rest + [ns])
    inv = list(range(len(rest)))
    inv.insert(sd, len(rest))
    return g.permute(inv)


def _rotate_nd(t: torch.Tensor, plan: NdPlan,
               signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized FWHT along axis 1 of (tiles, n_rot, Ns) float32, with
    optional signs fused in before it, through ``ops.fwht``: the tiles
    become contiguous (tiles*Ns, n_rot) rows and come back."""
    tiles, n, ns = t.shape
    rows = t.permute(0, 2, 1).reshape(tiles * ns, n).contiguous()
    out = ops.fwht(rows, signs=signs, scale=plan.n_rot ** -0.5)
    return out.reshape(tiles, ns, n).permute(0, 2, 1)


def fwht_nd(t: torch.Tensor, plan: NdPlan) -> torch.Tensor:
    """Normalized (self-inverse) FWHT along the rotation axis of a
    (tiles, n_rot, Ns) block: fwht_nd(fwht_nd(t)) == t."""
    return _rotate_nd(t.to(torch.float32), plan)


def encode_nd(g: torch.Tensor, signs: torch.Tensor, plan: NdPlan
              ) -> torch.Tensor:
    """leaf -> rotated tiles (tiles, n_rot, Ns) float32; signs (n_rot,)."""
    return _rotate_nd(to_tiles_nd(g.to(torch.float32), plan), plan, signs)


def decode_nd(tiles_sum: torch.Tensor, counts: torch.Tensor,
              signs: torch.Tensor, plan: NdPlan, *,
              total_peers: int = 1) -> torch.Tensor:
    """Inverse of :func:`encode_nd` over summed received tiles; counts
    (n_rot,).  The JAX order of float operations: peer unbias, sampling
    unbias, transform, scale, signs."""
    c = counts.to(torch.float32)[None, :, None]
    safe = torch.clamp(c, min=1.0)
    est = torch.where(c > 0, tiles_sum * torch.div(float(total_peers), safe),
                      0.0)
    k = (counts > 0).sum()
    est = est * torch.where(k > 0, torch.div(plan.n_rot, k.clamp(min=1)),
                            0.0)
    est = _rotate_nd(est, plan) * signs[None, :, None]
    return from_tiles_nd(est, plan)
