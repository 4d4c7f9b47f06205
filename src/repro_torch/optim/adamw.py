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

Schedule: linear warmup -> cosine decay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence

import torch

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


def init_opt_state(params: Leaves) -> Dict[str, Any]:
    return {
        "master": [p.detach().to(torch.float32, copy=True) for p in params],
        "mu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params],
        "nu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params],
        "count": torch.zeros((), dtype=torch.int32,
                             device=params[0].device),
    }


def global_norm(leaves: Leaves) -> torch.Tensor:
    total = 0
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def apply_updates(params: Leaves, grads: Leaves, state: Dict[str, Any],
                  cfg: OptConfig):
    """Returns (new params in their dtypes, new state, metrics)."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
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
    for g, m, v, w, p in zip(grads, state["mu"], state["nu"],
                             state["master"], params):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step = torch.div(torch.div(m, bc1),
                         torch.sqrt(torch.div(v, bc2)) + cfg.eps)
        w = w - lr * (step + cfg.weight_decay * w)
        mu.append(m)
        nu.append(v)
        master.append(w)
        new_params.append(w.to(p.dtype))
    new_state = {"master": master, "mu": mu, "nu": nu, "count": count}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
