"""Train step (port of ``repro/train/train_step.py``): one device, or
one rank of a data-parallel mesh over a ``torch.distributed`` process
group.

The gradient sync dispatches on
:class:`repro_torch.core.transport.coupling.CollectiveMode`
(``CelerisConfig.mode``).  On one device (``mesh=None``, the JAX
package's ``:454-499``):

- **exact**: no sync; on one device the gradient is the gradient;
- **lossy**: the Fig.-1 ablation without coding: wire rows beyond the
  bounded receiver window are holes in the raw gradient
  (:func:`_mask_grads_plain`);
- **lossy_hadamard**: the node still receives
  only (1 - drop_rate) of each payload inside its window, emulated per
  coded leaf as single-peer ``encode_nd`` -> mask -> unbiased
  ``decode_nd`` (:func:`_code_grads`); the rotations run on the FWHT
  kernel;
- **hierarchical**: on one device there is no pod axis to sync over,
  so it is the ``lossy_hadamard`` emulation at the cross-pod component
  of the drop vector (``drop_rate[-1]`` of the ``(2,)`` or
  ``(n_pods + 1,)`` vector a ``coupling.HierStragglerModel`` yields; a
  scalar is its own last component).

On a mesh (a DeviceMesh, :mod:`repro_torch.sharding`; the JAX
package's ``shard_map`` island, ``:148-225`` and ``:343-453``) each rank
takes the gradient of its own rows of the batch, then:

- **exact** (and a lossy mode with nothing to code): the float32 pmean
  over the dp axes (``pod``, ``data``), which equals the global batch's
  gradient because every shard holds as many tokens;
- **lossy**: per-(peer, wire-row) loss without coding: each peer masks
  its own raw tiles before the plain all-reduce
  (:func:`_sync_grads_plain_island`);
- **lossy_hadamard**: per coded leaf, encode, mask this peer's lost wire
  rows, all-reduce, and decode unbiased by the count of peers that
  delivered each row (:func:`_sync_grads_celeris`); with
  ``quantize_wire`` the contributions go as int8 codes on one scale a
  wire row, the all-ranks maximum of ``|contribution| / 127``;
- **hierarchical**: the float32 pmean over ``data`` (inside a pod),
  then the coded lossy all-reduce over ``pod`` alone, every data rank
  of a pod masking with its pod's mask; a ``(n_pods + 1,)`` vector
  charges pod p the rate ``1 - (1 - intra_p)(1 - cross)``, capped at
  ``MAX_DROP``.

Loss, nll and aux are averaged over the dp ranks, and ``recv_frac`` is
the fraction of all peers' wire rows that arrived, the same on every
rank.  The coded sync tiles each leaf around its ``model`` dimension
when the mesh has a ``model`` axis, even of size 1, as the JAX step's
``sharded_dim`` does (:mod:`repro_torch.train.sharding_rules`).

**Tensor parallelism.**  On a mesh whose ``model`` axis is larger than 1
each rank holds its shards of the leaves the specs split over ``model``
(``convert.shard_leaves``) and runs the model tensor parallel over its
``model`` group (:class:`repro_torch.sharding.ModelGroup`; Megatron
column/row layers, the vocab-parallel embedding and cross-entropy), the
collectives GSPMD emits for the JAX step written out.  The plans come
from the leaves' global shapes, so the rotation runs along the
unsharded axes and each model rank encodes, loses and decodes only its
own columns of a (tiles, n_rot, Ns / tp) block; the masks and signs are
per dp peer and the same on every model rank.  The one coupling is the
int8 wire's scale: JAX takes its maximum over the global tile block,
whose axis 2 is split, so the maximum runs over the ``model`` group as
well as the lossy peers, and the rounding noise is drawn at the global
shape, each rank keeping its columns.  The exact sync stays the float32
pmean over the dp axes of each rank's shards, and the global norm adds
up the split leaves' squares over ``model``.

**Gradient accumulation** (``microbatches`` M > 1, the JAX step's
``_accum_grads``): the rank's rows split in order into M microbatches,
gradients summed in float32 and scaled by 1/M into each leaf's dtype,
loss, nll and aux averaged; the sync runs once on the sum.  On one
device (no dp axis) the batch is taken whole, as the JAX step's no-dp
branch takes it.

Collectives (:func:`_all_reduce`) are ``torch.distributed.all_reduce``
on the group's ranks, on the gradients' own device: under gloo (four
ranks on one card, which NCCL refuses) the backend itself moves a CUDA
tensor through host memory.  No collective sums int16, so the int8
codes are summed as int32: the same integer sums as the JAX package's
int16, at 4 bytes an entry on the wire instead of 2.

Then AdamW (float32 master) updates the parameters.  **ZeRO-1**: on a
mesh whose ``data`` axis is larger than 1 each rank holds only its
``zero1_specs`` slice of ``master``, ``mu`` and ``nu`` (from
:func:`init_state` and from a restored checkpoint, :func:`state_specs`);
the gradient is whole on every dp rank after the sync, the clip factor
comes from it whole, the update walks this rank's slices, and the new
bfloat16 parameter slices are all-gathered over ``data``
(``sharding.data_all_gather``): bit for bit the replicated update.
ZeRO-1 spans ``data`` only, so the ranks of a ``pod`` hold equal slices.

The state is ``{"params", "opt", "step"}`` with the parameters in the
JAX leaf view (``models.convert``): the JAX step plans, codes and draws
per leaf index, and so does this one.  A step draws from the
``torch.Generator`` it is given.  On one device: one arrival mask per
coded leaf in leaf order, then (coded mode) one set of signs per coded
leaf, so ``lossy`` and ``lossy_hadamard`` lose the same rows from the
same generator.  On a mesh every rank holds an identically seeded
generator (``repro_torch.generator(dev, seed, step)``) and draws, per
coded leaf in leaf order, the masks of all mask peers (the dp peers, or
the pods in ``hierarchical`` mode) and keeps its own; then the signs;
then, leaf by leaf as it syncs, the int8 wire's rounding noise over the
whole contribution at the leaf's global tile shape.  So signs and noise
are the same on every rank and the masks are per (leaf, peer), as the
JAX package's ``fold_in`` draws are.  ``masks``/``signs``/``noise``
(leaf index -> tensor: this rank's mask, the signs, the noise at the
global shape) replace the draws; the tests hand in the JAX step's own.

**MoE** (qwen2-moe, granite-moe): the loss adds the layers' aux loss,
and on a ``model`` axis larger than 1 the MoE layers run expert parallel
(:mod:`repro_torch.models.moe`).  ``lossy_moe`` turns on the lossy
expert dispatch at the last component of ``drop_rate`` (the JAX step's
``LossyCtx``; inert on a dense model and off the EP path, as in JAX);
the arrival uniforms are each layer's fixed ones
(``moe.layer_coins``), or ``coins`` (layer -> (tp, tp) tensor) where
given.  The coded syncs plan, draw and code the MoE leaves at their JAX
leaf indices (``convert.leaf_names``).  Outside the lossy island on dp
ranks (``exact``, or a lossy mode with nothing to code) the JAX step is
one GSPMD program over the global batch, whose MoE layers fill every
expert's capacity from all dp shards' tokens together: there each rank
gathers the dp ranks' rows into its MoE layers (``sharding.RowGroup``)
and keeps its own rows of their output.  Not ported, and refused:
``microbatches`` there (JAX's microbatch is a block of the global
batch's rows, not of each shard's).

**The families.**  Every model of the JAX package trains: the dense
and MoE families, the recurrent ones (recurrentgemma's RG-LRU, xLSTM's
mLSTM and sLSTM: autograd through the port's scans) and the modality
stubs.  The leaf view follows the config (``convert.leaf_names``:
gemma2's two pattern groups, ``embed.unembed`` when untied, the
post-norms, no ``mlp.wg`` for squared ReLU, no QKV biases where the
config has none, the recurrent blocks' leaves, seamless's encoder
stack and cross-attention, ``frontend_proj``), and every draw is per
JAX leaf index.  A stub's batch may carry ``image_embeds`` or
``frame_embeds`` (rows with the tokens' rows; on a mesh this rank's);
without them the leaves the text does not reach get zero gradients,
as under ``jax.grad``, and AdamW still decays them.  Every family
runs on every mesh: on a ``model`` axis the recurrent blocks and the
stubs' frontend, encoder and cross-attention run tensor parallel as the
attention and MLP do (``models/model.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

import repro_torch
from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.core import coding
from repro_torch.core import lossy_collectives as lc
from repro_torch.core.transport.coupling import MAX_DROP, CollectiveMode
from repro_torch.core.transport.schedule import HierarchicalSchedule
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import sharding_rules as rules


@dataclasses.dataclass(frozen=True)
class CelerisConfig:
    """Celeris integration knobs for training.  ``use_pallas`` has no
    counterpart (``ops`` dispatches on the tensor's device), and neither
    has the legacy ``enabled`` switch: ``mode`` alone chooses the sync."""
    mode: str | CollectiveMode = CollectiveMode.EXACT
                                     # "exact" | "lossy" | "lossy_hadamard"
                                     # | "hierarchical"
    lossy_moe: bool = False          # lossy expert-parallel all-to-all
    n_rot: int = 4096                # Hadamard rotation width
    min_coded_size: int = 65536      # leaves smaller than this sync exactly
    wire_dtype: str = "float32"      # the coded all-reduce's payload dtype
                                     # (decode stays float32)
    quantize_wire: bool = False      # int8 codes on one shared scale a
                                     # wire row, summed as int32 over the
                                     # lossy axes; in hierarchical mode
                                     # only the cross-pod all-reduce

    def collective_mode(self) -> CollectiveMode:
        return CollectiveMode.parse(self.mode)


def loss_and_grads(cfg: ModelConfig, leaves, batch: Dict[str, torch.Tensor],
                   tp: Optional[shd.ModelGroup] = None,
                   lossy: Optional[M.LossyCtx] = None,
                   rows: Optional[shd.RowGroup] = None):
    """(loss, nll, aux, grads) of ``M.lm_loss`` (with its default remat
    and, on a model group, sequence parallelism, as JAX's step takes
    ``lm_loss``) at the JAX-leaf-view
    parameters (this rank's shards with ``tp``); the gradients come back
    as one tensor per leaf, zeros for a leaf the loss does not reach.
    ``lossy``: the MoE layers' lossy dispatch; ``rows``: the dp ranks
    whose rows they route together."""
    params = [leaf.detach().requires_grad_() for leaf in leaves]
    loss, (nll, aux) = M.lm_loss(
        convert.params_from_leaves(params, cfg), cfg,
        batch, tp, lossy, rows)
    # a leaf the batch does not reach (a stub's frontend, encoder and
    # cross-attention on text alone) gets zeros, as jax.grad gives it
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), nll.detach(), aux.detach(), list(grads)


def accum_grads(cfg: ModelConfig, leaves, batch: Dict[str, torch.Tensor],
                microbatches: int, tp: Optional[shd.ModelGroup] = None,
                lossy: Optional[M.LossyCtx] = None,
                rows: Optional[shd.RowGroup] = None):
    """:func:`loss_and_grads` over ``microbatches`` slices of the batch
    rows, in order (the JAX step's ``_accum_grads``): gradients summed in
    float32, then scaled by 1/M into each leaf's dtype; loss, nll and aux
    averaged."""
    if microbatches == 1:
        return loss_and_grads(cfg, leaves, batch, tp, lossy, rows)
    mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                       + tuple(v.shape[1:])) for k, v in batch.items()}
    gsum = [torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
            for leaf in leaves]
    loss = nll = aux = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
    for i in range(microbatches):
        l, n, a, g = loss_and_grads(cfg, leaves, {k: v[i] for k, v in
                                                  mb.items()}, tp, lossy)
        gsum = [x + y.to(torch.float32) for x, y in zip(gsum, g)]
        loss, nll, aux = loss + l, nll + n, aux + a
    inv = 1.0 / microbatches
    return (loss * inv, nll * inv, aux * inv,
            [(g * inv).to(leaf.dtype) for g, leaf in zip(gsum, leaves)])


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
    masked wire rows, and decode unbiased.  Each leaf's decoded gradient
    is written back into its own buffer (the gradients are the step's),
    and its tiles are masked in place, so a leaf's float32 buffers are
    freed before the next leaf's."""
    out, fracs = [], []
    for i, (g, plan) in enumerate(zip(grads, plans)):
        if plan is None:
            out.append(g)
            continue
        mask = masks[i].to(torch.float32)
        est = coding.decode_nd(
            coding.encode_nd(g, signs[i], plan).mul_(mask[None, :, None]),
            mask, signs[i], plan, total_peers=1)
        out.append(g.copy_(est))
        del est
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


# ----------------------------------------------------------------------
# Data-parallel sync over a process group
# ----------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """All-reduce ``t`` in place over ``group`` and return it (the one
    place the sync's collectives go through)."""
    dist.all_reduce(t, op=op, group=group)
    return t


def check_replicated(leaves, group) -> None:
    """Raise unless every rank of ``group`` holds the same tensors, bit
    for bit: each is broadcast from the group's first rank and compared
    as bytes."""
    src = dist.get_global_rank(group, 0)
    for i, leaf in enumerate(leaves):
        mine = leaf.detach().reshape(-1).view(torch.uint8)
        ref = mine.clone()
        dist.broadcast(ref, src=src, group=group)
        if not torch.equal(ref, mine):
            raise RuntimeError(f"leaf {i} differs from rank {src}'s: the "
                               "ranks did not start from the same weights")


@dataclasses.dataclass(frozen=True)
class _Axes:
    """One sync's process group and its size; ``peer`` is this rank's
    index along it, the mask peer."""
    group: object
    size: int
    peer: int


def _pmean(x: torch.Tensor, axes: _Axes) -> torch.Tensor:
    """Float32 mean over the ranks of ``axes`` (divided by a tensor: a
    Python-scalar divisor is not an IEEE quotient on the card)."""
    s = _all_reduce(x.to(torch.float32, copy=True), axes.group)
    return torch.div(s, torch.tensor(float(axes.size), device=s.device))


def _int8_wire(contrib: torch.Tensor, noise: torch.Tensor, lossy: _Axes,
               model: Optional[shd.ModelGroup] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's inline int8 wire (``train_step.py:175-187``):
    one scale a wire row, the maximum of ``|contrib|`` over tiles, the
    sharded dim and every peer, / 127; codes ``floor(contrib / scale +
    noise)`` clipped to +-127.  Returns (codes as int32, scale).
    ``model``: the group over which the sharded dim is split (its
    maximum is taken there too)."""
    absmax = torch.amax(torch.abs(contrib), dim=(0, 2))
    if model is not None:
        shd.model_all_reduce(absmax, model, dist.ReduceOp.MAX)
    absmax = _all_reduce(absmax, lossy.group, dist.ReduceOp.MAX)
    scale = torch.where(absmax > 0,
                        torch.div(absmax, torch.full_like(absmax, 127.0)),
                        1.0)
    q = torch.floor(torch.div(contrib, scale[None, :, None]) + noise)
    return torch.clamp(q, -127.0, 127.0).to(torch.int32), scale


def _sync_grads_celeris(grads, plans, masks, signs, noise, celeris,
                        dp: _Axes, lossy: _Axes,
                        exact: Optional[_Axes] = None,
                        model: Optional[shd.ModelGroup] = None):
    """Per-leaf lossy pmean with Hadamard recovery over ``lossy``.  Small
    leaves take the exact pmean over ``dp``.  ``exact`` (hierarchical
    mode: the pod's data ranks) first takes the exact float32 pmean of
    each coded leaf, which then stays float32, as in the JAX package.
    ``noise(i, shape)`` gives leaf i's int8 rounding noise for this
    rank's block of that shape.  ``model``: the tensor-parallel group,
    over which each leaf with a sharded dim is split."""
    out, fracs = [], []
    n_lossy = torch.tensor(float(lossy.size), device=grads[0].device)
    for i, (g, plan) in enumerate(zip(grads, plans)):
        if plan is None:
            out.append(_pmean(g, dp).to(g.dtype))
            continue
        if exact is not None:
            g = _pmean(g, exact)
        tiles = coding.encode_nd(g, signs[i], plan)
        mask = masks[i]
        contrib = tiles * mask[None, :, None].to(tiles.dtype)
        if celeris.quantize_wire:
            q, scale = _int8_wire(contrib, noise(i, contrib.shape), lossy,
                                  model if plan.sharded_dim is not None
                                  else None)
            tiles_sum = (_all_reduce(q, lossy.group).to(torch.float32)
                         * scale[None, :, None])
        else:
            contrib = contrib.to(getattr(torch, celeris.wire_dtype))
            tiles_sum = _all_reduce(contrib, lossy.group).to(torch.float32)
        counts = _all_reduce(mask.to(torch.float32), lossy.group)
        est = coding.decode_nd(tiles_sum, counts, signs[i], plan,
                               total_peers=lossy.size)
        out.append(torch.div(est, n_lossy).to(g.dtype))
        fracs.append(torch.div(counts.sum(), n_lossy * plan.n_rot))
    return out, _mean_frac(fracs, grads[0])


def _sync_grads_plain_island(grads, plans, masks, dp: _Axes):
    """Per-(peer, wire-row) loss WITHOUT coding: each peer masks its own
    raw tiles before the plain all-reduce, so a dropped row is missing
    from that peer only, with no recovery and no rescaling."""
    out, fracs = [], []
    n_dp = torch.tensor(float(dp.size), device=grads[0].device)
    for i, (g, plan) in enumerate(zip(grads, plans)):
        if plan is None:
            out.append(_pmean(g, dp).to(g.dtype))
            continue
        tiles = coding.to_tiles_nd(g.to(torch.float32), plan)
        mask = masks[i]
        masked = tiles * mask[None, :, None].to(tiles.dtype)
        tiles_sum = _all_reduce(masked, dp.group)
        counts = _all_reduce(mask.to(torch.float32), dp.group)
        out.append(coding.from_tiles_nd(torch.div(tiles_sum, n_dp), plan)
                   .to(g.dtype))
        fracs.append(torch.div(counts.sum(), n_dp * plan.n_rot))
    return out, _mean_frac(fracs, grads[0])


def _draw_dp(generator, plans, rates, peer, coded, masks, signs, device):
    """The mesh draws, the same on every rank: per coded leaf the masks
    of all mask peers, ``rand(peers, n_rot) >= rates[:, None]``, of which
    this rank keeps row ``peer``; then the signs.  An injected tensor
    replaces its draw."""
    masks, signs = masks or {}, signs or {}
    idx = [i for i, p in enumerate(plans) if p is not None]
    if generator is None and any(i not in masks or (coded and i not in signs)
                                 for i in idx):
        raise ValueError("the lossy train step needs a generator, or masks "
                         "(and signs) for every coded leaf")
    rates = rates.to(generator.device if generator is not None else device)
    m = {}
    for i in idx:
        if i in masks:
            m[i] = masks[i]
        else:
            u = repro_torch.rand((rates.shape[0], plans[i].n_rot),
                                 generator)
            m[i] = (u >= rates[:, None])[peer]
    s = {i: signs[i] if i in signs
         else coding.rademacher_nd(generator, plans[i])
         for i in idx} if coded else {}
    return ({i: t.to(device) for i, t in m.items()},
            {i: t.to(device) for i, t in s.items()})


def _pod_rates(drop_rate, n_pods: int) -> torch.Tensor:
    """Hierarchical mode's mask rate of each pod, float32: the cross-pod
    component of the drop vector; a ``(n_pods + 1,)`` vector charges pod
    p ``1 - (1 - intra_p)(1 - cross)``, capped at ``MAX_DROP``."""
    dr = torch.as_tensor(np.reshape(np.asarray(drop_rate, np.float32), -1))
    cross = dr[-1].expand(n_pods)
    if dr.shape[0] == n_pods + 1 and n_pods > 1:
        cross = torch.clamp(1.0 - (1.0 - dr[:n_pods]) * (1.0 - cross),
                            max=MAX_DROP)
    return cross


def plan_leaves(shapes, mesh, celeris: CelerisConfig, names):
    """Each leaf's coding plan from its global shape, None for a leaf
    that syncs exactly: tiles of ``n_rot`` around the leaf's ``model``
    dimension when the mesh has that axis (the JAX train step's
    ``plans``, which compare the global size with ``min_coded_size``).
    ``names``: the leaves' (``convert.leaf_names``)."""
    shapes = [tuple(s) for s in shapes]
    specs = (rules.param_specs(shapes, mesh, names) if mesh is not None
             else [()] * len(shapes))
    return [coding.plan_nd(shape, rules.sharded_dim(spec), celeris.n_rot)
            if math.prod(shape) >= celeris.min_coded_size else None
            for shape, spec in zip(shapes, specs)]


@dataclasses.dataclass(frozen=True)
class _DpSync:
    """What the mesh path's sync needs: the mode, the dp group, in
    hierarchical mode the pod group (mask peer: the pod) and the data
    group (None when the mesh has no data axis), and the model group
    (None without tensor parallelism)."""
    mode: CollectiveMode
    celeris: CelerisConfig
    island: bool                     # a lossy sync; else the exact pmean
    dp: _Axes
    pod: Optional[_Axes] = None
    data: Optional[_Axes] = None
    model: Optional[shd.ModelGroup] = None

    @classmethod
    def make(cls, mesh, mode, celeris,
             model: Optional[shd.ModelGroup] = None) -> "_DpSync":
        dp = shd.dp_axes(mesh)
        pod_axes = tuple(a for a in dp if a == shd.POD_AXIS)
        data_axes = tuple(a for a in dp if a != shd.POD_AXIS)
        peer = shd.peer_index(mesh, dp)
        dp_ax = _Axes(shd.group(mesh, dp), shd.axis_size(mesh, dp), peer)
        if mode is not CollectiveMode.HIERARCHICAL:
            return cls(mode, celeris, mode.lossy, dp_ax, model=model)
        n_data = shd.axis_size(mesh, data_axes)
        pod = _Axes(shd.group(mesh, pod_axes), shd.axis_size(mesh, pod_axes),
                    peer // n_data)
        data = (_Axes(shd.group(mesh, data_axes), n_data,
                      shd.peer_index(mesh, data_axes)) if data_axes else None)
        return cls(mode, celeris, True, dp_ax, pod, data, model)


def _sync_dp(sync: _DpSync, grads, plans, generator, drop_rate, masks,
             signs, noise):
    """The mesh path's gradient sync: (synced grads, recv_frac)."""
    if not (sync.island and any(p is not None for p in plans)):
        return ([_pmean(g, sync.dp).to(g.dtype) for g in grads],
                _mean_frac([], grads[0]))
    dev = grads[0].device
    noise = noise or {}

    def draw_noise(i, shape):
        # drawn (or given) at the leaf's global block; this rank's columns
        tiles, n_rot, ns = shape
        split = sync.model is not None and plans[i].sharded_dim is not None
        if i in noise:
            full = noise[i]
        elif generator is None:
            raise ValueError("the int8 wire needs a generator, or noise "
                             "for every coded leaf")
        else:
            full = repro_torch.rand((tiles, n_rot, ns * sync.model.size
                                     if split else ns), generator)
        if split:
            full = full.narrow(2, sync.model.index * ns, ns)
        return full.to(dev)

    if sync.mode is CollectiveMode.HIERARCHICAL:
        rates = _pod_rates(drop_rate, sync.pod.size)
        m, s = _draw_dp(generator, plans, rates, sync.pod.peer, True, masks,
                        signs, dev)
        return _sync_grads_celeris(grads, plans, m, s, draw_noise,
                                   sync.celeris, sync.dp, sync.pod,
                                   sync.data, sync.model)
    rates = torch.full((sync.dp.size,), float(drop_rate),
                       dtype=torch.float32)
    m, s = _draw_dp(generator, plans, rates, sync.dp.peer, sync.mode.coded,
                    masks, signs, dev)
    if sync.mode is CollectiveMode.LOSSY:
        return _sync_grads_plain_island(grads, plans, m, sync.dp)
    return _sync_grads_celeris(grads, plans, m, s, draw_noise, sync.celeris,
                               sync.dp, sync.dp, model=sync.model)


def make_train_step(cfg: ModelConfig, mesh=None,
                    opt_cfg: Optional[adamw.OptConfig] = None,
                    celeris: Optional[CelerisConfig] = None,
                    microbatches: int = 1, donate: bool = False):
    """Returns ``step(state, batch, generator, drop_rate, *, masks=None,
    signs=None, noise=None, coins=None) -> (state, metrics)``.

    ``mesh``: None (one device) or this rank's DeviceMesh; every rank of
    it builds its step together (the dp groups are made here).  The
    step's ``dp_group`` attribute is its process group over the dp axes
    (None without a mesh), and ``model_group`` its
    :class:`~repro_torch.sharding.ModelGroup` (None without tensor
    parallelism); the state's parameters are then this rank's shards
    (``convert.shard_leaves``).
    ``batch`` = {"tokens", "labels"} (B, S) int64 on the parameters'
    device, with a stub's ``image_embeds`` or ``frame_embeds`` (B, ...)
    where given: this rank's rows on a mesh (the same on every model
    rank);
    on a mesh B divisible by ``microbatches``, which one device ignores
    (as the JAX step does).  ``drop_rate`` a float, or in
    ``hierarchical`` mode the axis vector whose last component is the
    cross-pod rate.  The metrics are 0-dim tensors: ``loss``, ``nll``,
    ``aux``, ``recv_frac``, ``grad_norm``, ``lr``.

    ``donate``: the step updates the optimizer state it is given in place
    (``adamw.apply_updates(donate=True)``; the JAX step donates its
    state, ``donate=True`` by default there), so one copy of the float32
    state is resident, not two; the caller must not use or step that state
    again.  Off by default: a step then leaves its input state as it
    was.
    """
    M.check_supported(cfg)   # at build time
    opt_cfg = opt_cfg or adamw.OptConfig()
    celeris = celeris or CelerisConfig()
    mode = celeris.collective_mode()
    dp = shd.dp_axes(mesh) if mesh is not None else ()
    if mode is CollectiveMode.HIERARCHICAL and dp and shd.POD_AXIS not in dp:
        raise ValueError(
            "hierarchical collective mode needs a 'pod' mesh axis "
            "(launch.mesh.make_pod_mesh / make_scale_mesh >= 512); "
            f"got dp axes {dp}")
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
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}: need at least 1")

    tp = convert.model_group(cfg, mesh)
    zero = convert.data_group(cfg, mesh)
    plans = plan_leaves(convert.leaf_shapes(cfg), mesh, celeris,
                        convert.leaf_names(cfg))
    split = [tp is not None and n in tp.split
             for n in convert.short_names(cfg)]
    # one device takes the batch whole, as the JAX step's no-dp branch
    accum = microbatches if dp else 1
    dp_sync = _DpSync.make(mesh, mode, celeris, tp) if dp else None
    # outside the lossy island JAX's step is one GSPMD program over the
    # global batch: its MoE layers route every dp shard's rows together
    rows = None
    if (cfg.moe is not None and dp_sync is not None
            and dp_sync.dp.size > 1
            and not (dp_sync.island and any(p is not None for p in plans))):
        if accum > 1:
            raise NotImplementedError(
                f"{cfg.name}: microbatches on dp ranks outside the lossy "
                "island are not ported for MoE (JAX's microbatch is a block "
                "of the global batch's rows)")
        rows = shd.RowGroup(dp_sync.dp.group, dp_sync.dp.size,
                            dp_sync.dp.peer)

    def train_step(state, batch, generator: Optional[torch.Generator],
                   drop_rate, *, masks=None, signs=None, noise=None,
                   coins=None):
        leaves = state["params"]
        # the expert exchange crosses pods: the drop vector's last component
        lossy = M.LossyCtx(enabled=celeris.lossy_moe,
                           drop_rate=float(np.reshape(drop_rate, -1)[-1]),
                           coins=coins)
        loss, nll, aux, grads = accum_grads(cfg, leaves, batch, accum, tp,
                                            lossy, rows)
        if dp_sync is not None:
            grads, frac = _sync_dp(dp_sync, grads, plans, generator,
                                   drop_rate, masks, signs, noise)
            loss, nll, aux = (_pmean(x, dp_sync.dp) for x in (loss, nll, aux))
        elif mode.lossy:
            if mode.hierarchical:
                drop_rate = float(np.reshape(drop_rate, -1)[-1])
            m, s = _draw(generator, plans, drop_rate, mode.coded, masks,
                         signs, leaves[0].device)
            if mode.coded:
                grads, frac = _code_grads(grads, plans, m, s)
            else:
                grads, frac = _mask_grads_plain(grads, plans, m)
        else:
            frac = _mean_frac([], loss)
        new_params, new_opt, om = adamw.apply_updates(
            leaves, grads, state["opt"], opt_cfg, tp, split, zero, donate)
        metrics = {"loss": loss, "nll": nll, "aux": aux,
                   "recv_frac": frac, **om}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    train_step.dp_group = dp_sync.dp.group if dp_sync is not None else None
    train_step.model_group = tp
    train_step.data_group = zero
    return train_step


def init_state(generator: torch.Generator, cfg: ModelConfig, mesh=None):
    """Random parameters on the generator's device, in the JAX leaf view,
    with their optimizer state.  On a mesh with a ``model`` axis the
    whole parameters are drawn and this rank keeps its shards
    (``convert.shard_leaves``)."""
    names = convert.leaf_names(cfg)
    leaves = convert.jax_leaves(M.init_params(cfg, generator), cfg)
    if shd.model_group(mesh) is not None:
        leaves = convert.shard_leaves(leaves, mesh, names)
    return state_from_params(leaves, cfg, mesh)


def state_from_params(leaves, cfg: ModelConfig, mesh=None):
    """The train state at step 0 from this rank's parameter leaves: the
    optimizer state over its ZeRO-1 slices on a ``data`` axis larger than
    1 (``convert.data_group``)."""
    return {"params": list(leaves),
            "opt": adamw.init_opt_state(leaves,
                                        convert.data_group(cfg, mesh)),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def state_specs(shapes, mesh, names):
    """The partition spec of every state leaf on ``mesh``, shaped as the
    state (JAX's ``state_shardings``), from the leaves' global
    ``shapes`` and ``names``: the parameter specs, ZeRO-1 for the
    optimizer state."""
    return {"params": rules.param_specs(shapes, mesh, names),
            "opt": rules.opt_state_specs(shapes, mesh, names), "step": ()}


_OPT_LISTS = ("master", "mu", "nu")


def state_leaves(state, names) -> list:
    """The state's leaves (or those of :func:`state_specs`) as
    ``(path, leaf)`` in JAX's flatten order, the path JAX's ``keystr`` of
    the same leaf of its state tree: ``['opt']['count']``, then
    ``['opt']['master']`` + each leaf's ``keystr``, ``mu``, ``nu``, the
    ``['params']``, and ``['step']``.  ``names``: the parameter leaves'
    (``convert.leaf_names``)."""
    if len(names) != len(state["params"]):
        raise ValueError(f"{len(names)} names for {len(state['params'])} "
                         "parameter leaves")
    out = [("['opt']['count']", state["opt"]["count"])]
    for part in _OPT_LISTS:
        out += [(f"['opt']['{part}']" + rules.keystr(n), x)
                for n, x in zip(names, state["opt"][part])]
    out += [("['params']" + rules.keystr(n), x)
            for n, x in zip(names, state["params"])]
    return out + [("['step']", state["step"])]


def state_from_leaves(leaves):
    """Inverse of :func:`state_leaves`, from the leaves alone in that
    order."""
    leaves = list(leaves)
    n = (len(leaves) - 2) // 4
    if len(leaves) != 4 * n + 2 or n < 1:
        raise ValueError(f"{len(leaves)} state leaves, expected 4 n + 2")
    opt = {part: leaves[1 + k * n:1 + (k + 1) * n]
           for k, part in enumerate(_OPT_LISTS)}
    return {"params": leaves[1 + 3 * n:1 + 4 * n],
            "opt": dict(opt, count=leaves[0]), "step": leaves[-1]}
