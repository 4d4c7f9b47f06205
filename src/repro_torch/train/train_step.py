"""Train step (port of ``repro/train/train_step.py``, the single-device
path, ``:454-499``).

The gradient sync dispatches on
:class:`repro_torch.core.transport.coupling.CollectiveMode`
(``CelerisConfig.mode``):

- **exact**: no sync; on one device the gradient is the gradient;
- **lossy**: the Fig.-1 ablation without coding: wire rows beyond the
  bounded receiver window are holes in the raw gradient
  (:func:`_mask_grads_plain`);
- **lossy_hadamard**: the node still receives
  only (1 - drop_rate) of each payload inside its window, emulated per
  coded leaf as single-peer ``encode_nd`` -> mask -> unbiased
  ``decode_nd`` (:func:`_code_grads`); the rotations run on the FWHT
  kernel;
- **hierarchical**: exact intra-pod, coded lossy cross-pod.  On one
  device there is no pod axis to sync over, so it is the
  ``lossy_hadamard`` emulation at the cross-pod component of the drop
  vector (``drop_rate[-1]`` of the ``(2,)`` or ``(n_pods + 1,)`` vector
  a ``coupling.HierStragglerModel`` yields; a scalar is its own last
  component).

Then AdamW (float32 master) updates the parameters.

The state is ``{"params", "opt", "step"}`` with the parameters in the
JAX leaf view (``models.convert``): the JAX step plans, codes and draws
per leaf index, and so does this one.  A step draws from the
``torch.Generator`` it is given, one arrival mask per coded leaf in
leaf order, then (coded mode) one set of signs per coded leaf, so
``lossy`` and ``lossy_hadamard`` lose the same rows from the same
generator.  ``masks``/``signs`` (leaf index -> tensor) replace the
draws; the tests hand in the JAX step's own.

Not ported yet, and refused: a mesh or process group (the DP coded sync
``_sync_grads_celeris`` with its inline int8 wire, the plain island, and
the hierarchical pod/data split), ``microbatches > 1`` and ``lossy_moe``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import coding
from repro_torch.core import lossy_collectives as lc
from repro_torch.core.transport.coupling import CollectiveMode
from repro_torch.core.transport.schedule import HierarchicalSchedule
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class CelerisConfig:
    """Celeris integration knobs for training.  The JAX fields for the
    data-parallel sync (``wire_dtype``, ``quantize_wire``) arrive with
    it; ``use_pallas`` has no counterpart (``ops`` dispatches on the
    tensor's device), and neither has the legacy ``enabled`` switch:
    ``mode`` alone chooses the sync."""
    mode: str | CollectiveMode = CollectiveMode.EXACT
                                     # "exact" | "lossy" | "lossy_hadamard"
                                     # | "hierarchical"
    lossy_moe: bool = False          # lossy expert-parallel all-to-all
    n_rot: int = 4096                # Hadamard rotation width
    min_coded_size: int = 65536      # leaves smaller than this sync exactly

    def collective_mode(self) -> CollectiveMode:
        return CollectiveMode.parse(self.mode)


def loss_and_grads(cfg: ModelConfig, leaves, batch: Dict[str, torch.Tensor]):
    """(loss, nll, aux, grads) of ``M.lm_loss`` at the JAX-leaf-view
    parameters; the gradients come back as one tensor per leaf."""
    params = [leaf.detach().requires_grad_() for leaf in leaves]
    loss, (nll, aux) = M.lm_loss(convert.params_from_leaves(params), cfg,
                                 batch)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), nll.detach(), aux, list(grads)


def _mean_frac(fracs, like: torch.Tensor) -> torch.Tensor:
    if not fracs:
        return torch.ones((), dtype=torch.float32, device=like.device)
    return torch.stack(fracs).mean()


def _mask_grads_plain(grads, plans, masks):
    """Receiver-window loss WITHOUT coding, the Fig.-1 ablation: one
    arrival mask per coded leaf zeroes wire rows of its raw tile layout,
    with no recovery."""
    out, fracs = [], []
    for i, (g, plan) in enumerate(zip(grads, plans)):
        if plan is None:
            out.append(g)
            continue
        mask = masks[i].to(torch.float32)
        tiles = coding.to_tiles_nd(g.to(torch.float32), plan)
        out.append(coding.from_tiles_nd(tiles * mask[None, :, None], plan)
                   .to(g.dtype))
        fracs.append(mask.mean())
    return out, _mean_frac(fracs, grads[0])


def _code_grads(grads, plans, masks, signs):
    """Single-peer coded emulation: per coded leaf, rotate, drop the
    masked wire rows, and decode unbiased."""
    out, fracs = [], []
    for i, (g, plan) in enumerate(zip(grads, plans)):
        if plan is None:
            out.append(g)
            continue
        mask = masks[i].to(torch.float32)
        tiles = coding.encode_nd(g, signs[i], plan)
        est = coding.decode_nd(tiles * mask[None, :, None], mask, signs[i],
                               plan, total_peers=1)
        out.append(est.to(g.dtype))
        fracs.append(mask.mean())
    return out, _mean_frac(fracs, grads[0])


def _draw(generator, plans, drop_rate, coded, masks, signs, device):
    """Per coded leaf: the arrival masks (all of them first, in leaf
    order), then the signs; an injected tensor replaces its draw."""
    masks, signs = masks or {}, signs or {}
    idx = [i for i, p in enumerate(plans) if p is not None]
    if generator is None and any(i not in masks or (coded and i not in signs)
                                 for i in idx):
        raise ValueError("the lossy train step needs a generator, or masks "
                         "(and signs) for every coded leaf")
    m = {i: masks[i] if i in masks
         else lc.arrival_mask(generator, plans[i].n_rot, drop_rate)
         for i in idx}
    s = {i: signs[i] if i in signs
         else coding.rademacher_nd(generator, plans[i])
         for i in idx} if coded else {}
    return ({i: t.to(device) for i, t in m.items()},
            {i: t.to(device) for i, t in s.items()})


def make_train_step(cfg: ModelConfig, mesh=None,
                    opt_cfg: Optional[adamw.OptConfig] = None,
                    celeris: Optional[CelerisConfig] = None,
                    microbatches: int = 1):
    """Returns ``step(state, batch, generator, drop_rate, *, masks=None,
    signs=None) -> (state, metrics)``.

    ``batch`` = {"tokens", "labels"} (B, S) int64 on the parameters'
    device; ``drop_rate`` a float, or in ``hierarchical`` mode the axis
    vector whose last component is the cross-pod rate.  The metrics are
    0-dim tensors: ``loss``, ``nll``, ``aux``, ``recv_frac``,
    ``grad_norm``, ``lr``.
    """
    opt_cfg = opt_cfg or adamw.OptConfig()
    celeris = celeris or CelerisConfig()
    mode = celeris.collective_mode()
    if mesh is not None:
        raise NotImplementedError("the data-parallel train step (a mesh or "
                                  "process group) is not ported yet")
    if mode is CollectiveMode.HIERARCHICAL:
        # the sync order (exact intra-pod, then the coded cross-pod
        # exchange) mirrors the schedule's phases, and the mode masks only
        # the DCI shards, which the schedule must cut first
        order = HierarchicalSchedule.PHASE_ORDER
        assert order[0] == "rs" and order[-1] == "ag" and "dci" in order, (
            f"CollectiveMode.HIERARCHICAL assumes intra-reduce -> DCI "
            f"exchange -> intra-gather; HierarchicalSchedule.PHASE_ORDER "
            f"is {order}")
        prio = HierarchicalSchedule.PRIORITY
        assert prio["dci"] < min(prio["rs"], prio["ag"]), (
            f"CollectiveMode.HIERARCHICAL masks only DCI shards, so the "
            f"DCI phase must be the lowest priority class; "
            f"HierarchicalSchedule.PRIORITY is {prio}")
    if microbatches > 1:
        raise NotImplementedError("microbatches > 1 is not ported yet")
    if celeris.lossy_moe:
        raise NotImplementedError("lossy_moe is not ported yet (no MoE "
                                  "family)")

    def train_step(state, batch, generator: Optional[torch.Generator],
                   drop_rate: float, *, masks=None, signs=None):
        leaves = state["params"]
        plans = [coding.plan_nd(tuple(leaf.shape), None, celeris.n_rot)
                 if leaf.numel() >= celeris.min_coded_size else None
                 for leaf in leaves]
        loss, nll, aux, grads = loss_and_grads(cfg, leaves, batch)
        if mode.hierarchical:
            drop_rate = float(np.reshape(drop_rate, -1)[-1])
        if mode.lossy:
            m, s = _draw(generator, plans, drop_rate, mode.coded, masks,
                         signs, leaves[0].device)
            if mode.coded:
                grads, frac = _code_grads(grads, plans, m, s)
            else:
                grads, frac = _mask_grads_plain(grads, plans, m)
        else:
            frac = _mean_frac([], loss)
        new_params, new_opt, om = adamw.apply_updates(
            leaves, grads, state["opt"], opt_cfg)
        metrics = {"loss": loss, "nll": nll, "aux": aux,
                   "recv_frac": frac, **om}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def init_state(generator: torch.Generator, cfg: ModelConfig):
    """Random parameters on the generator's device, in the JAX leaf view,
    with their optimizer state."""
    leaves = convert.jax_leaves(M.init_params(cfg, generator))
    return {"params": leaves, "opt": adamw.init_opt_state(leaves),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}
