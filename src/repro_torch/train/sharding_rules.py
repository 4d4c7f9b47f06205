"""Partition specs for parameters, optimizer state and batches (port of
``repro/train/sharding_rules.py``).

A spec is a tuple with one entry a leaf dimension: the mesh axis that
dimension is split over, or None.  The JAX package hands its specs to
GSPMD; the port reads them itself: ``convert.shard_leaves`` keeps each
rank's slice of the leaves split over ``model`` (tensor parallelism),
the coded sync plans each leaf's tiles around its ``model`` dimension
(``coding.plan_nd(shape, sharded_dim, n_rot)``; that dimension is set
whenever the mesh *has* a ``model`` axis, even of size 1), and the
model reads which leaves are split (``convert.model_group``).
:func:`zero1_specs` places the optimizer state (:func:`opt_state_specs`):
each rank keeps its ``data`` slice of ``master``, ``mu`` and ``nu``
(``convert.data_group``), from init and from a restored checkpoint, as
the JAX package states its layout.  :func:`batch_specs` places a served
batch's rows (``serve_step.local_batch``); the trainer takes its rows as
``shard_batch`` of its row-major dp index, which is what the batch specs
give.  :func:`cache_specs` places the serving caches: JAX's rule over
the dp axes, and the port's ``model`` layout of each node where it is
given (``model.cache_split_dims``, ``model.local_caches``).

TP policy (megatron-style over ``model``), as in the JAX package:
- attention/MLP in-projections: column-parallel  (..., None, "model")
- out-projections: row-parallel                  (..., "model", None)
- embedding: vocab-sharded; unembed column-parallel
- MoE experts: expert-sharded
- norms / small diagonals: replicated

ZeRO-1: optimizer-state leaves additionally split their largest
dp-divisible dimension over ``data``.

The rules match the JAX package's path strings: a port leaf name
(``convert.leaf_names``, e.g. ``decoder.groups[1].attn.wq``) is written
as JAX's ``keystr`` (``['decoder']['groups'][0]['attn']['wq']``) before
matching, so the regexes are the JAX package's own.  Stacked layer
groups (a leading layer dim) get a None prepended.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import sharding as shd

Spec = Tuple[Optional[str], ...]

# (path regex, spec builder given leaf ndim) -- first match wins.
# Specs are written for the UNSTACKED leaf; leading extra dims -> None.
_RULES = [
    # embedding
    (r"embed.*table", lambda nd: ("model", None)),
    (r"embed.*unembed", lambda nd: (None, "model")),
    (r"frontend_proj", lambda nd: (None, "model")),
    # attention
    (r"\['attn'\].*w[qkv]", lambda nd: (None, "model")),
    (r"\['attn'\].*wo", lambda nd: ("model", None)),
    (r"\['xattn'\].*w[qkv]", lambda nd: (None, "model")),
    (r"\['xattn'\].*wo", lambda nd: ("model", None)),
    (r"\['attn'\].*b[qkv]", lambda nd: ("model",)),
    (r"\['xattn'\].*b[qkv]", lambda nd: ("model",)),
    # dense mlp
    (r"\['mlp'\].*w[ig]", lambda nd: (None, "model")),
    (r"\['mlp'\].*wo", lambda nd: ("model", None)),
    # moe (expert-sharded; shared experts like dense mlp)
    (r"\['moe'\].*shared.*w[ig]", lambda nd: (None, "model")),
    (r"\['moe'\].*shared.*wo", lambda nd: ("model", None)),
    (r"\['moe'\].*router", lambda nd: (None, None)),
    (r"\['moe'\].*w[igo]", lambda nd: ("model", None, None)),
    # rglru
    (r"\['rglru'\].*w_in", lambda nd: (None, "model")),
    (r"\['rglru'\].*w_gate", lambda nd: (None, "model")),
    (r"\['rglru'\].*w_out", lambda nd: ("model", None)),
    (r"\['rglru'\].*conv_[wb]", lambda nd: (None, "model")[-nd:]),
    (r"\['rglru'\].*(gate_._[wb]|lam)", lambda nd: ("model",)),
    # xlstm
    (r"\['mlstm'\].*w_(up|gate)", lambda nd: (None, "model")),
    (r"\['mlstm'\].*w[qkv]", lambda nd: (None, "model")),
    (r"\['mlstm'\].*w_down", lambda nd: ("model", None)),
    (r"\['slstm'\].*w_x", lambda nd: (None, "model")),
    (r"\['slstm'\].*w_up[12]", lambda nd: (None, "model")),
    (r"\['slstm'\].*w_down", lambda nd: ("model", None)),
]


def keystr(name: str) -> str:
    """``decoder.groups[0].attn.wq`` -> ``['decoder']['groups'][0]['attn']
    ['wq']``, JAX's ``keystr`` of the same leaf."""
    out = []
    for part in name.split("."):
        key, _, idx = part.partition("[")
        out.append(f"['{key}']" + (f"[{idx}" if idx else ""))
    return "".join(out)


def _spec_for(path: str, shape: Sequence[int], sizes: Dict[str, int]
              ) -> Spec:
    ndim = len(shape)
    for pat, builder in _RULES:
        if re.search(pat, path):
            spec = list(builder(ndim))
            while len(spec) < ndim:        # stacked group leading dims
                spec.insert(0, None)
            spec = spec[:ndim]
            # divisibility guard: replicate dims the axis doesn't divide
            # or that the mesh doesn't carry at all
            return tuple(None if s is not None and (
                s not in sizes or n % sizes[s] != 0) else s
                for s, n in zip(spec, shape))
    return ()   # replicated (norms, biases, scalars)


def param_specs(shapes: Sequence[Sequence[int]], mesh,
                names: Sequence[str]) -> List[Spec]:
    """One spec a leaf, for leaves of these shapes and paths (the JAX
    leaf view's, ``convert.leaf_names``)."""
    if len(shapes) != len(names):
        raise ValueError(f"{len(shapes)} shapes for {len(names)} names")
    sizes = shd.axis_sizes(mesh)
    return [_spec_for(keystr(n), tuple(s), sizes)
            for n, s in zip(names, shapes)]


def sharded_dim(spec: Spec) -> Optional[int]:
    """The leaf dimension on the ``model`` axis, if any: the coded sync
    tiles around it (the JAX train step's ``sharded_dim``)."""
    for i, s in enumerate(spec):
        if s == shd.MODEL_AXIS:
            return i
    return None


def zero1_specs(shapes: Sequence[Sequence[int]], mesh,
                names: Sequence[str]) -> List[Spec]:
    """Optimizer-state specs: the param spec + 'data' on the largest
    free, divisible dim (ZeRO-1)."""
    sizes = shd.axis_sizes(mesh)
    dp_size = sizes.get("data", 1)
    out = []
    for shape, spec in zip(shapes, param_specs(shapes, mesh, names)):
        if "data" not in sizes or len(shape) == 0:
            out.append(spec)
            continue
        parts = list(spec) + [None] * (len(shape) - len(spec))
        best, best_dim = -1, -1
        for i, (s, n) in enumerate(zip(parts, shape)):
            if s is None and n % dp_size == 0 and n > best:
                best, best_dim = n, i
        if best_dim >= 0:
            parts[best_dim] = "data"
        out.append(tuple(parts))
    return out


def opt_state_specs(shapes: Sequence[Sequence[int]], mesh,
                    names: Sequence[str]) -> Dict[str, object]:
    """The AdamW state's specs (JAX's ``opt_state_shardings``): ZeRO-1
    for ``master``, ``mu`` and ``nu``, none for ``count``."""
    z = zero1_specs(shapes, mesh, names)
    return {"master": z, "mu": z, "nu": z, "count": ()}


def batch_specs(mesh, batch: Dict[str, object]) -> Dict[str, tuple]:
    """The batch rows split over the dp axes together (one axis is
    named alone, as a JAX PartitionSpec normalizes it)."""
    dp = shd.dp_axes(mesh)
    rows = dp[0] if len(dp) == 1 else dp
    return {k: (rows,) + (None,) * (len(v.shape) - 1)
            for k, v in batch.items()}


def cache_specs(mesh, caches, model_dims=None):
    """The serving caches' specs (JAX's ``cache_specs``): the batch dim
    over the dp axes, dim 1 of a stacked group node's tensors (a leading
    layer dim) and dim 0 of a tail node's; the ``pos`` arrays ((n_groups,
    S) or (S,)) replicated.  Returns ``caches``' structure (a
    ``model.Caches`` of nodes) with a spec in place of each tensor.

    ``model_dims``: one {field: dim from the end} a node, in
    ``caches.nodes()`` order, naming the fields a rank holds its slice of
    over ``model`` (``model.cache_split_dims``).  The JAX package pins no
    cache dim to ``model`` (``serve_step.py:10-14``), so its specs are
    the ones without them; the port's caches are laid out as the layers
    compute them under tensor parallelism."""
    dp = shd.dp_axes(mesh)
    rows = (dp[0] if len(dp) == 1 else dp) if dp else None
    nodes = list(caches.groups) + list(caches.tail)
    model_dims = model_dims or [{}] * len(nodes)
    n_groups = len(caches.groups)

    def node_specs(j, node):
        out = []
        for field, t in zip(
                (f for f in type(node).__dataclass_fields__), node.tensors()):
            lead = 1 if j < n_groups else 0
            spec = [None] * t.dim()
            if t.dim() > lead + 1:           # not a pos array
                spec[lead] = rows
            dim = model_dims[j].get(field)
            if dim is not None:
                spec[t.dim() + dim] = shd.MODEL_AXIS
            out.append(tuple(spec) if any(spec) else ())
        return type(node)(*out)

    specs = [node_specs(j, n) for j, n in enumerate(nodes)]
    return type(caches)(groups=specs[:n_groups], tail=specs[n_groups:])
