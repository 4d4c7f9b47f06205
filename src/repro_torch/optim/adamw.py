"""AdamW with mixed precision + global-norm clipping (port of
``repro/optim/adamw.py``).

Model parameters live in the compute dtype (bf16); the optimizer keeps
a float32 master copy and float32 moments.  Parameters, gradients and
every state entry are lists of tensors in one order (the trainer's JAX
leaf view), so the global norm sums the leaves in JAX's order.  The
scalar math (schedule, bias corrections, clip factor) is done in
float32 0-dim tensors on the parameters' device, as JAX does it, and
every division is by a tensor: a Python-scalar divisor is taken as a
multiply by its reciprocal on the card.

On a mesh with a ``model`` axis each rank holds its shards of the
leaves that the specs split over ``model``: the global norm adds up
their squares over the model group and counts the replicated leaves
once, so the clip factor is the same on every rank.

ZeRO-1 (``zero``, a :class:`~repro_torch.sharding.DataGroup`): on a
``data`` axis larger than 1 each rank keeps only its slice of
``master``, ``mu`` and ``nu`` along each leaf's ``zero.dims`` entry.  The
clip factor still comes from the whole gradients; the update walks the
slices, and the new parameters' slices are all-gathered over ``data``.
AdamW is elementwise and the cast commutes with the gather, so the new
parameters are bit for bit the replicated update's.

Schedule: linear warmup -> cosine decay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import sharding as shd

Leaves = Sequence[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.div(step, _f32(max(cfg.warmup_steps, 1), step))
    prog = torch.div(step - cfg.warmup_steps,
                     _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step))
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def zero_slice(x: torch.Tensor, zero: Optional[shd.DataGroup], i: int
               ) -> torch.Tensor:
    """Leaf i's slice that this rank's ZeRO-1 state covers (a view; the
    whole leaf without ZeRO-1 or when the leaf is kept whole)."""
    dim = zero.dims[i] if zero is not None else None
    if dim is None:
        return x
    n = x.shape[dim] // zero.size
    return x.narrow(dim, zero.index * n, n)


def init_opt_state(params: Leaves, zero: Optional[shd.DataGroup] = None
                   ) -> Dict[str, Any]:
    """Float32 master and zero moments for ``params`` (this rank's ZeRO-1
    slices of them with ``zero``)."""
    params = [zero_slice(p, zero, i) for i, p in enumerate(params)]
    return {
        "master": [p.detach().to(torch.float32, copy=True) for p in params],
        "mu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params],
        "nu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params],
        "count": torch.zeros((), dtype=torch.int32,
                             device=params[0].device),
    }


def _sum_squares(leaves: Leaves):
    total = 0
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return total


def global_norm(leaves: Leaves, tp: Optional[shd.ModelGroup] = None,
                split: Sequence[bool] = ()) -> torch.Tensor:
    """The norm of all the leaves together.  With ``tp``, ``split[i]``
    says leaf i is this rank's shard of a leaf split over ``model``:
    those squares are summed over the model group, the others counted
    once."""
    if tp is None or not any(split):
        return torch.sqrt(_sum_squares(leaves))
    shards = _sum_squares([l for l, s in zip(leaves, split) if s])
    whole = _sum_squares([l for l, s in zip(leaves, split) if not s])
    return torch.sqrt(shd.model_all_reduce(shards, tp) + whole)


def apply_updates(params: Leaves, grads: Leaves, state: Dict[str, Any],
                  cfg: OptConfig, tp: Optional[shd.ModelGroup] = None,
                  split: Sequence[bool] = (),
                  zero: Optional[shd.DataGroup] = None,
                  donate: bool = False):
    """Returns (new params in their dtypes, new state, metrics).  ``tp``
    and ``split``: :func:`global_norm`'s; ``zero``: the state holds this
    rank's ZeRO-1 slices (:func:`init_opt_state`).

    ``donate``: ``master``, ``mu`` and ``nu`` are updated in place (the
    new state holds the same tensors), as the JAX step's donated state
    lets XLA reuse its buffers, with two leaf-sized temporaries instead
    of a second copy of the state.  The caller must hold no other use
    for the state it passes, and never steps it again.  Without it the
    same update runs on copies, so both modes give the same bits."""
    count = state["count"] + 1
    gnorm = global_norm(grads, tp, split)
    scale = torch.clamp(
        torch.div(_f32(cfg.clip_norm, gnorm), torch.clamp(gnorm, min=1e-9)),
        max=1.0)
    lr = schedule(cfg, count)

    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, c), c)
    bc2 = 1 - torch.pow(_f32(b2, c), c)

    mu: List[torch.Tensor] = []
    nu: List[torch.Tensor] = []
    master: List[torch.Tensor] = []
    new_params: List[torch.Tensor] = []
    for i, (g, m, v, w, p) in enumerate(zip(grads, state["mu"], state["nu"],
                                            state["master"], params)):
        g = zero_slice(g, zero, i).to(torch.float32) * scale
        if not donate:
            m, v, w = m.clone(), v.clone(), w.clone()
        _update_in_place(g, m, v, w, lr, bc1, bc2, cfg)
        mu.append(m)
        nu.append(v)
        master.append(w)
        if zero is not None and zero.dims[i] is not None:
            new_params.append(shd.data_all_gather(w.to(p.dtype), zero,
                                                  zero.dims[i]))
        else:
            new_params.append(w.to(p.dtype))
    new_state = {"master": master, "mu": mu, "nu": nu, "count": count}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _update_in_place(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, lr, bc1, bc2, cfg: OptConfig) -> None:
    """One leaf's AdamW update written into ``m``, ``v`` and ``w``, in
    JAX's order of float32 operations, with ``g``'s buffer reused once
    it is spent."""
    m.mul_(cfg.b1).add_(torch.mul(g, 1 - cfg.b1))
    v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    denom = torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps)
    step = torch.div(m, bc1).div_(denom)
    w.sub_(step.add_(torch.mul(w, cfg.weight_decay, out=g)).mul_(lr))
