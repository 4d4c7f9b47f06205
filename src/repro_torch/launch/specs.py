"""Abstract inputs of a rank's program, per (arch x shape) cell (port of
``repro/launch/specs.py``).

Nothing is allocated: each input is a :class:`Spec`, this rank's local
meta tensor beside the global shape and the partition spec on the mesh
(JAX's ``ShapeDtypeStruct`` with a ``NamedSharding``).  A partition spec
is a tuple with one entry a dimension: a mesh axis, a tuple of axes
taken together, or None; ``()`` is replicated.  Without a mesh every
spec is ``()`` and the local tensor is the whole one.  The dry run
(``launch/dryrun.py``) hands the local tensors to the builders the card
runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch

import repro_torch
from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.serve import serve_step
from repro_torch.train import sharding_rules as rules
from repro_torch.train import train_step as ts

Partition = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Spec:
    """One input of a rank's program: ``local``, its block on this rank
    (a meta tensor), ``shape``, the global shape, and ``spec``, the
    partition spec that cuts one into the other."""
    local: torch.Tensor
    shape: Tuple[int, ...]
    spec: Partition

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def local_shape(shape: Sequence[int], spec: Partition, mesh
                ) -> Tuple[int, ...]:
    """The block of ``shape`` a rank holds under ``spec``: each named dim
    divided by the size of its axes (:func:`repro_torch.sharding.
    block_slices`'s cut)."""
    sizes = shd.axis_sizes(mesh)
    out = list(shape)
    for i, axis in enumerate(spec):
        if axis is not None:
            axes = (axis,) if isinstance(axis, str) else tuple(axis)
            out[i] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def _spec(shape, dtype, mesh=None, spec: Partition = ()) -> Spec:
    spec = tuple(spec) if mesh is not None else ()
    shape = tuple(shape)
    return Spec(torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                            device="meta"), shape, spec)


def _of(t: torch.Tensor, shape, spec: Partition) -> Spec:
    """A rank's tensor beside its global shape and spec."""
    return Spec(t, tuple(shape), tuple(spec))


def locals_of(tree):
    """``tree`` with each :class:`Spec` replaced by its local tensor."""
    if isinstance(tree, Spec):
        return tree.local
    if isinstance(tree, dict):
        return {k: locals_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(locals_of(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(locals_of(getattr(tree, f.name))
                            for f in dataclasses.fields(tree)))
    return tree


def _batch_spec(mesh, batch_size: int) -> Partition:
    """The rows over the dp axes only when they divide them
    (``long_500k``'s B = 1 stays whole), as JAX's ``_batch_spec``."""
    if mesh is None:
        return ()
    dp = shd.dp_axes(mesh)
    n = shd.axis_size(mesh, dp)
    if batch_size % n == 0 and batch_size >= n:
        return (dp[0] if len(dp) == 1 else dp,)
    return (None,)


def token_extras(cfg: ModelConfig, b: int, s: int, mesh=None
                 ) -> Dict[str, Spec]:
    """The frontend stub's inputs (``serve_step.frontend_inputs``'s
    shapes and dtype), rows split as the batch's."""
    bspec = _batch_spec(mesh, b)
    whole = serve_step.frontend_inputs(cfg, b, s,
                                       repro_torch.generator("meta"))
    return {k: _spec(v.shape, v.dtype, mesh, bspec + (None, None))
            for k, v in whole.items()}


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None
                      ) -> Dict[str, Spec]:
    """tokens and labels (B, S - image positions) int32, and the frontend
    inputs."""
    b, s = shape.global_batch, shape.seq_len
    bspec = _batch_spec(mesh, b)
    batch = {k: _spec((b, s - cfg.n_front), torch.int32, mesh,
                      bspec + (None,)) for k in ("tokens", "labels")}
    batch.update(token_extras(cfg, b, s, mesh))
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None
                        ) -> Dict[str, Spec]:
    b, s = shape.global_batch, shape.seq_len
    bspec = _batch_spec(mesh, b)
    batch = {"tokens": _spec((b, s - cfg.n_front), torch.int32, mesh,
                             bspec + (None,))}
    batch.update(token_extras(cfg, b, s, mesh))
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       tp=None):
    """(batch, caches, index) of one decode step: tokens (B, 1) int32 and
    an enc-dec model's ``memory`` (B, 1024, d) bf16; the caches of
    ``model.init_caches`` for B rows of ``seq_len`` slots, each tensor's
    spec JAX's dp rule (a stacked node's dim 1, a tail node's dim 0; the
    ``pos`` arrays replicated) and the port's ``model`` layout where
    ``tp`` splits it (``model.cache_split_dims``); the index () int32."""
    b, s_max = shape.global_batch, shape.seq_len
    bspec = _batch_spec(mesh, b)
    batch = {"tokens": _spec((b, 1), torch.int32, mesh, bspec + (None,))}
    if cfg.is_encdec:
        batch["memory"] = _spec((b, 1024, cfg.d_model), torch.bfloat16,
                                mesh, bspec + (None, None))
    whole = M.init_caches(cfg, b, s_max, "meta")
    dims = M.cache_split_dims(cfg, tp)
    model_dims = [dims[k] for k in M.cache_kinds(cfg)]
    nodes = whole.nodes()
    n = len(whole.groups)
    out = []
    for j, node in enumerate(nodes):
        lead = 1 if j < n else 0
        specs = []
        for f, t in zip(dataclasses.fields(node), node.tensors()):
            spec = [None] * t.dim()
            if t.dim() > lead + 1 and mesh is not None:   # not a pos array
                spec[lead] = bspec[0]
            dim = model_dims[j].get(f.name)
            if dim is not None:
                spec[t.dim() + dim] = shd.MODEL_AXIS
            spec = tuple(spec) if any(a is not None for a in spec) else ()
            specs.append(_spec(t.shape, t.dtype, mesh, spec))
        out.append(type(node)(*specs))
    caches = M.Caches(groups=out[:n], tail=out[n:])
    return batch, caches, _spec((), torch.int32, mesh, ())


def abstract_params(cfg: ModelConfig, mesh=None):
    """The parameter leaves in the JAX leaf view (``convert.leaf_names``
    order), each this rank's shard beside the global leaf and its
    ``sharding_rules.param_specs`` spec."""
    names = convert.leaf_names(cfg)
    whole = convert.jax_leaves(
        M.init_params(cfg, repro_torch.generator("meta")), cfg)
    shapes = [tuple(t.shape) for t in whole]
    specs = (rules.param_specs(shapes, mesh, names) if mesh is not None
             else [()] * len(whole))
    return [_spec(s, t.dtype, mesh, sp)
            for s, t, sp in zip(shapes, whole, specs)]


def abstract_state(cfg: ModelConfig, mesh=None):
    """The train state (``train_step.state_from_params``: the parameters,
    AdamW's float32 master and moments, the step) with this rank's
    blocks beside the global shapes and ``train_step.state_specs``:
    ZeRO-1 over ``data`` for the optimizer state
    (``sharding_rules.zero1_specs``)."""
    params = abstract_params(cfg, mesh)
    state = ts.state_from_params([p.local for p in params], cfg, mesh)
    shapes = [p.shape for p in params]
    specs = (ts.state_specs(shapes, mesh, convert.leaf_names(cfg))
             if mesh is not None else None)
    opt = {}
    for part in ("master", "mu", "nu"):
        sp = specs["opt"][part] if specs else [()] * len(shapes)
        opt[part] = [_of(t, s, p) for t, s, p in
                     zip(state["opt"][part], shapes, sp)]
    opt["count"] = _of(state["opt"]["count"], (), ())
    return {"params": params, "opt": opt,
            "step": _of(state["step"], (), ())}
