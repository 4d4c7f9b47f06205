"""Lossy (best-effort) collectives on ``torch.distributed`` (port of
``repro/core/lossy_collectives.py``).

Celeris discards packets that miss the bounded delivery window; here,
as in the JAX package, the loss is emulated at wire-row granularity
inside the collective: every participant draws a per-(peer, wire-row)
arrival mask from the step's drop probability and contributes only the
rows that arrived.  Receivers finalize with what they have and recover
through the Hadamard/XOR coding layer (:mod:`repro_torch.core.coding`).

Each function takes a process ``group`` where JAX takes an axis name,
and lowers to plain ``all_reduce`` / ``all_gather`` / ``all_to_all``
calls plus elementwise masking.  A peer's draws come from a generator
seeded from (seed, rank), the port of JAX's ``fold_in(key,
axis_index)``; the int8 wire's rounding noise from (seed, rank, 1).
Tests pass the ``mask`` (and ``noise``) in as tensors instead, so both
frameworks see the same draws.

Provided:
- :func:`lossy_psum` / :func:`lossy_pmean`: gradient all-reduce (DP),
  optionally on an int8 wire (``quantize_wire``);
- :func:`lossy_all_gather`: gather with XOR parity repair;
- :func:`lossy_all_to_all`: dropped blocks surface as an arrival mask;
- exact twins (``exact_*``) for A/B runs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import generator, rand
from repro_torch.core import coding


def _world(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def arrival_mask(gen: torch.Generator, n_rows: int,
                 drop_rate: float) -> torch.Tensor:
    """Bernoulli(1 - drop_rate) per wire row: True = arrived in window."""
    return rand((n_rows,), gen) >= drop_rate


def _peer_mask(seed: int, group, n_rows: int, drop_rate: float,
               device) -> torch.Tensor:
    return arrival_mask(generator(device, seed, _world(group)[1]), n_rows,
                        drop_rate)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(P, *t.shape): every peer's ``t`` in rank order."""
    out = [torch.empty_like(t) for _ in range(_world(group)[0])]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """JAX's ``all_to_all``: block j of ``x`` along ``split_axis`` goes
    to peer j; the blocks received are concatenated along
    ``concat_axis`` in source order."""
    p = _world(group)[0]
    send = torch.stack(x.chunk(p, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


# ----------------------------------------------------------------------
# All-reduce (data-parallel gradient sync)
# ----------------------------------------------------------------------

def lossy_psum(x: torch.Tensor, group=None, *, seed: int, drop_rate: float,
               signs: torch.Tensor, code: coding.HadamardCode,
               quantize_wire: bool = False,
               mask: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-effort all-reduce of a flat float32 payload.

    Returns (unbiased sum estimate, realized received fraction as a
    0-dim tensor).  ``signs``/``code`` must be identical on every peer.

    ``quantize_wire=True`` quantizes each peer's wire contribution to
    absmax int8 per rotation block before the reduce
    (``coding.encode_quantized``: rotate and quantize in one fused
    kernel), modelling a 4x smaller payload; its rounding noise comes
    from a generator of its own, so the mask draws are the same either
    way.  ``mask`` (n_rot,) bool and ``noise`` (n_blocks, n_rot) replace
    this peer's draws.
    """
    peers, rank = _world(group)
    dev = x.device
    if mask is None:
        mask = _peer_mask(seed, group, code.n_rot, drop_rate, dev)
    if quantize_wire:
        gen = None if noise is not None else generator(dev, seed, rank, 1)
        q_wire, scales = coding.encode_quantized(x, signs, code, gen,
                                                 noise=noise)
        wire = coding.dequantize_wire(q_wire, scales)
    else:
        wire = coding.encode(x, signs, code)
    contrib = wire * mask[:, None].to(wire.dtype)
    counts = mask.to(torch.float32)
    dist.all_reduce(contrib, group=group)
    dist.all_reduce(counts, group=group)
    est = coding.decode(contrib, counts, signs, code, total_peers=peers)
    return est, counts.sum() / (peers * code.n_rot)


def lossy_pmean(x: torch.Tensor, group=None, **kw):
    s, frac = lossy_psum(x, group, **kw)
    return s / _world(group)[0], frac


def exact_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def exact_pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    return exact_psum(x, group) / _world(group)[0]


# ----------------------------------------------------------------------
# All-gather (tensor-parallel activations) with XOR parity repair
# ----------------------------------------------------------------------

def _xor_allreduce(bits: torch.Tensor, group) -> torch.Tensor:
    """XOR all-reduce via gather + fold (no collective has an XOR op)."""
    return coding._xor_rows(_all_gather(bits, group))


def lossy_all_gather(x: torch.Tensor, group=None, *, seed: int,
                     drop_rate: float, parity: bool = True,
                     tiled: bool = False,
                     mask: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-effort all-gather of this shard (float32).

    Each peer's shard is one chunk; a dropped chunk is zero-filled.  With
    ``parity`` an XOR parity chunk rides along and repairs any *single*
    lost shard exactly.  ``mask`` (P,) bool replaces this peer's draw;
    entry ``rank`` says whether this peer's shard arrives.

    Returns (gathered (P, ...) or tiled, arrived mask (P,) bool).
    """
    p, me = _world(group)
    if mask is None:
        mask = _peer_mask(seed, group, p, drop_rate, x.device)
    arrived_here = mask[me]
    contrib = torch.where(arrived_here, x, torch.zeros_like(x))
    gathered = _all_gather(contrib, group)
    arrived = _all_gather(arrived_here.to(torch.float32).reshape(1),
                          group).reshape(p) > 0
    if parity:
        flat = gathered.reshape(p, -1)
        pbits = x.reshape(-1).contiguous().view(torch.int32)
        parity_chunk = _xor_allreduce(pbits, group).view(torch.float32)
        gathered = coding.xor_parity_decode(flat, parity_chunk,
                                            arrived).reshape(gathered.shape)
    if tiled:
        gathered = gathered.reshape((p * x.shape[0],) + tuple(x.shape[1:]))
    return gathered, arrived


def exact_all_gather(x: torch.Tensor, group=None, *,
                     tiled: bool = False) -> torch.Tensor:
    g = _all_gather(x, group)
    return g.reshape((-1,) + tuple(x.shape[1:])) if tiled else g


# ----------------------------------------------------------------------
# All-to-all (expert-parallel dispatch)
# ----------------------------------------------------------------------

def lossy_all_to_all(x: torch.Tensor, group=None, *, seed: int,
                     drop_rate: float, split_axis: int = 0,
                     concat_axis: int = 0,
                     mask: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-effort all-to-all.

    ``x`` is split into P blocks along ``split_axis``; block j travels to
    peer j and is dropped i.i.d. with ``drop_rate`` (``mask`` (P,) bool:
    this peer's per-destination coins).  Returns (received tensor with
    dropped blocks zeroed, arrival mask (P,): True where the block from
    peer j arrived here).
    """
    p = _world(group)[0]
    if x.shape[split_axis] != p:
        raise ValueError(f"all-to-all needs {p} blocks along axis "
                         f"{split_axis}, got shape {tuple(x.shape)}")
    if mask is None:
        mask = _peer_mask(seed, group, p, drop_rate, x.device)
    shape = [1] * x.dim()
    shape[split_axis] = p
    masked = x * mask.reshape(shape).to(x.dtype)
    recv = _all_to_all(masked, group, split_axis, concat_axis)
    arrived = _all_to_all(mask.to(torch.float32)[:, None], group, 0, 0)
    return recv, arrived[:, 0] > 0


def exact_all_to_all(x: torch.Tensor, group=None, *, split_axis: int = 0,
                     concat_axis: int = 0) -> torch.Tensor:
    return _all_to_all(x, group, split_axis, concat_axis)
