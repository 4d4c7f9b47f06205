"""Meshes over a ``torch.distributed`` process group (port of
``repro/sharding.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
axes (``mesh_dim_names``), one rank a mesh point.  The JAX package
reduces over a mesh axis by name inside ``shard_map``; the port reduces
over the process group of the ranks that share every other coordinate
(:func:`group`).

No counterpart: ``shard_map`` (each rank runs its shard's program
itself, so there is no island to open) and ``axis_size`` (an axis'
size is static on the mesh: :func:`axis_size`).  The JAX package's
partitioner gate ``plain_lossy_island_supported`` has nothing to gate
here: the port always runs the per-(peer, wire-row) plain island, the
jax >= 0.8 behaviour.

Tensor parallelism over ``model`` (:class:`ModelGroup` and the Megatron
operators :func:`copy_to_model`, :func:`reduce_from_model` and
:func:`gather_from_model`; for expert parallelism :func:`scatter_to_model`,
:func:`gather_replicated` and :func:`all_to_all_model`) has no
counterpart either: GSPMD emits those collectives from the JAX package's
partition specs and sharding constraints, and the port writes them out.
Sequence parallelism (:func:`split_sequence`, :func:`gather_sequence`)
is JAX's pin of the residual stream seq-sharded over ``model`` between
remat units, which GSPMD turns into the same copies.  Every collective
over the ``model`` group goes through
:func:`model_all_reduce`, :func:`model_all_gather`,
:func:`model_reduce_scatter` or :func:`model_all_to_all`, in the
tensor's own dtype, as GSPMD's do.

ZeRO-1 over ``data`` (:class:`DataGroup`, :func:`data_all_gather`) has
none either: GSPMD gathers the parameters that a ``data``-sharded
optimizer state updates, and the port gathers them itself.
:func:`local_slice` is the port's ``device_put`` with a partition spec:
a rank's block of a whole array.  :class:`RowGroup` and
:func:`gather_rows` stand in for GSPMD's view of the global batch where
the JAX step routes all dp shards' tokens through one MoE dispatch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` over the default process group, which
    must hold exactly ``prod(shape)`` ranks."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the process "
                         f"group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def axis_sizes(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """{axis name: size}: the JAX ``mesh.shape``."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: Optional[DeviceMesh], axes: Sequence[str]) -> int:
    """Ranks along ``axes`` together (1 for none, or without a mesh)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


# ----------------------------------------------------------------------
# Ambient mesh registry, as in the JAX package.
# ----------------------------------------------------------------------

_GLOBAL_MESH: Optional[DeviceMesh] = None


def set_global_mesh(mesh: Optional[DeviceMesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Optional[DeviceMesh]:
    return _GLOBAL_MESH


def dp_axes(mesh: Optional[DeviceMesh] = None) -> Tuple[str, ...]:
    """Data-parallel axes of the production meshes ('pod' composes)."""
    mesh = mesh if mesh is not None else _GLOBAL_MESH
    if mesh is None:
        return ()
    return tuple(a for a in mesh.mesh_dim_names if a in (POD_AXIS, DATA_AXIS))


def coordinate(mesh: DeviceMesh, rank: Optional[int] = None
               ) -> Dict[str, int]:
    """{axis name: index} of ``rank`` on ``mesh`` (this rank's when
    None)."""
    if rank is None:
        return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    at = (mesh.mesh == rank).nonzero()[0]
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in at)))


def peer_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-major index along ``axes``, in mesh order: the
    JAX island's ``peer`` (a P(dp)-sharded arange)."""
    return _row_major(axis_sizes(mesh), coordinate(mesh), axes)


def _row_major(sizes: Dict[str, int], coords: Dict[str, int],
               axes: Sequence[str]) -> int:
    idx = 0
    for a in (a for a in sizes if a in axes):
        idx = idx * sizes[a] + coords[a]
    return idx


def block_slices(shape: Sequence[int], spec: Sequence, sizes: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of the block that the rank at ``coords`` ({axis:
    index}, :func:`coordinate`) holds of a whole array of ``shape`` on a
    mesh of ``sizes`` (:func:`axis_sizes`, mesh order) under the
    partition ``spec``: each dimension named by a mesh axis (or a tuple
    of axes, taken together row-major in mesh order, :func:`peer_index`)
    is cut into that many blocks and the one at the rank's index kept;
    dimensions past ``spec`` stay whole."""
    index = []
    for axis, n in zip(spec, shape):
        if axis is None:
            index.append(slice(None))
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        block = n // math.prod(sizes[a] for a in axes)
        i = _row_major(sizes, coords, axes)
        index.append(slice(i * block, (i + 1) * block))
    return tuple(index)


def local_slice(x, spec: Sequence[Optional[str]], mesh: DeviceMesh):
    """This rank's block of the whole array ``x`` (a numpy array, a
    memory map or a tensor; a view of it) under the partition ``spec``
    (:func:`block_slices`)."""
    return x[block_slices(x.shape, spec, axis_sizes(mesh),
                          coordinate(mesh))]


def group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group over ``axes``: this rank and every rank that
    differs from it only along ``axes``.

    A single axis is the DeviceMesh's own group.  Several axes (the dp
    group over ``("pod", "data")``) are flattened with ``dist.new_group``,
    one group for each slice of the other axes: every rank makes all of
    them in the same order, as ``new_group`` requires, and keeps its own.
    So every rank calls this together, and a caller keeps the group it
    gets rather than asking again.
    """
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    ranks = mesh.mesh.permute(rest + keep).reshape(
        -1, math.prod(mesh.mesh.shape[i] for i in keep))
    mine = None
    for row in ranks.tolist():
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


# ----------------------------------------------------------------------
# Tensor parallelism over the model axis
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's place on the ``model`` axis: the process group of the
    ranks that differ from it only along ``model``, its size, this
    rank's index along it (which shard of each split leaf it holds), and
    the names of the leaves the partition specs split over it
    (``convert.model_group`` fills them in from the specs)."""
    group: object
    size: int
    index: int
    split: frozenset = frozenset()


def model_group(mesh: Optional[DeviceMesh]) -> Optional[ModelGroup]:
    """The ``model`` group of this rank, or None when the mesh has no
    ``model`` axis larger than 1 (no tensor parallelism)."""
    size = axis_sizes(mesh).get(MODEL_AXIS, 1)
    if size == 1:
        return None
    return ModelGroup(group(mesh, (MODEL_AXIS,)), size,
                      peer_index(mesh, (MODEL_AXIS,)))


def model_all_reduce(t: torch.Tensor, tp: ModelGroup,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place over the model group and return it."""
    dist.all_reduce(t, op=op, group=tp.group)
    return t


def model_all_gather(t: torch.Tensor, tp: ModelGroup,
                     dim: int = -1) -> torch.Tensor:
    """The model ranks' ``t`` side by side along ``dim`` (the last by
    default), in rank order."""
    first = t.movedim(dim, 0).contiguous()
    out = first.new_empty((tp.size * first.shape[0],) + first.shape[1:])
    dist.all_gather_into_tensor(out, first, group=tp.group)
    return out.movedim(0, dim)


def model_reduce_scatter(t: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """The sum of the model ranks' ``t``, of which this rank keeps its
    slice of the last dim (the inverse layout of
    :func:`model_all_gather`)."""
    first = t.movedim(-1, 0).contiguous()
    out = first.new_empty((first.shape[0] // tp.size,) + first.shape[1:])
    dist.reduce_scatter_tensor(out, first, group=tp.group)
    return out.movedim(0, -1)


def model_all_to_all(t: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """The all-to-all over the model group: ``t`` (tp, ...) sends its
    block ``j`` to rank ``j``; block ``i`` of the result came from rank
    ``i``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=tp.group)
    return out


# ----------------------------------------------------------------------
# ZeRO-1 over the data axis
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This rank's place on the ``data`` axis, over which ZeRO-1 splits
    the optimizer state: the process group of the ranks that differ from
    it only along ``data``, its size, this rank's index along it, and
    each leaf's dimension split over it, None for a leaf kept whole
    (``convert.data_group`` fills them in from the ZeRO-1 specs)."""
    group: object
    size: int
    index: int
    dims: Tuple[Optional[int], ...] = ()


def data_group(mesh: Optional[DeviceMesh]) -> Optional[DataGroup]:
    """The ``data`` group of this rank, or None when the mesh has no
    ``data`` axis larger than 1 (no ZeRO-1)."""
    size = axis_sizes(mesh).get(DATA_AXIS, 1)
    if size == 1:
        return None
    return DataGroup(group(mesh, (DATA_AXIS,)), size,
                     peer_index(mesh, (DATA_AXIS,)))


def data_all_gather(t: torch.Tensor, dg: DataGroup, dim: int
                    ) -> torch.Tensor:
    """The data ranks' ``t`` side by side along ``dim``, in rank order
    (contiguous, as the whole leaf it rebuilds)."""
    first = t.movedim(dim, 0).contiguous()
    out = first.new_empty((dg.size * first.shape[0],) + first.shape[1:])
    dist.all_gather_into_tensor(out, first, group=dg.group)
    return out.movedim(0, dim).contiguous()


@dataclasses.dataclass(frozen=True)
class RowGroup:
    """The dp ranks whose rows of the batch an MoE layer routes together
    (the JAX step's global-batch dispatch outside the lossy island): the
    process group, its size and this rank's index, whose rows are block
    ``index`` of the gathered batch."""
    group: object
    size: int
    index: int


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rg):
        ctx.rg = rg
        x = x.contiguous()
        out = x.new_empty((rg.size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=rg.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // ctx.rg.size,)
                             + grad.shape[1:])
        dist.reduce_scatter_tensor(out, grad, group=ctx.rg.group)
        return out, None


def gather_rows(x: torch.Tensor, rg: RowGroup) -> torch.Tensor:
    """The ranks' rows stacked along dim 0, in rank order; the backward
    sums each rank's gradient of every block and hands a rank its own
    (every rank computes the gathered rows' routing, and the aux loss
    over all of them)."""
    return _GatherRows.apply(x, rg)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad.clone(memory_format=torch
                                           .contiguous_format), ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return model_all_reduce(x.clone(memory_format=torch.contiguous_format),
                                tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return model_all_gather(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return model_reduce_scatter(grad, ctx.tp), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.index * n, n)

    @staticmethod
    def backward(ctx, grad):
        return model_all_gather(grad, ctx.tp, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return model_all_gather(x, tp, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // ctx.tp.size
        return grad.narrow(ctx.dim, ctx.tp.index * n, n), None, None


class _AllToAllModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return model_all_to_all(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return model_all_to_all(grad, ctx.tp), None


def scatter_to_model(x: torch.Tensor, tp: ModelGroup,
                     dim: int) -> torch.Tensor:
    """This rank's slice of the replicated ``x`` along ``dim``; the
    backward all-gathers the slices' gradients, so the replicated
    gradient is whole on every rank (expert parallelism's sequence
    split: each rank's slice gets its gradient on that rank alone)."""
    return _ScatterToModel.apply(x, tp, dim)


def gather_replicated(x: torch.Tensor, tp: ModelGroup,
                      dim: int) -> torch.Tensor:
    """All-gather along ``dim`` into a tensor every rank then uses alike;
    the backward keeps this rank's slice of the (replicated) gradient.
    The inverse of :func:`scatter_to_model`, and the gather of a split
    leaf that every rank uses whole and identically (the MoE experts on
    the local path)."""
    return _GatherReplicated.apply(x, tp, dim)


def all_to_all_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """:func:`model_all_to_all` with the reverse all-to-all as its
    backward (the EP dispatch and return)."""
    return _AllToAllModel.apply(x, tp)


def copy_to_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """Megatron's *f*: identity forward; the backward sums the gradient
    over the model group.  The input of a column-parallel layer (each
    rank's share of the gradient covers only its own columns), and a
    weight that the divisibility guard keeps whole inside one."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """Megatron's *g*: sums the model ranks' partial ``x`` forward;
    identity backward.  The output of a row-parallel layer."""
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """All-gather along the last dim forward; the backward
    reduce-scatters, so each rank's gradient is the sum of every rank's
    partial gradient of its own slice."""
    return _GatherFromModel.apply(x, tp)


class _SplitSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        n = x.shape[1] // tp.size
        return x.narrow(1, tp.index * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return model_all_gather(grad, ctx.tp, 1).contiguous(), None


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return model_all_gather(x, tp, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[1] // ctx.tp.size
        return grad.narrow(1, ctx.tp.index * n, n).clone(
            memory_format=torch.contiguous_format), None


def split_sequence(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """This rank's block of the sequence, a copy: (B, S, ...) ->
    (B, S / tp, ...), block ``index`` in rank order along ``model``, so
    the whole stream it came from can be freed.  The backward
    all-gathers the blocks' gradients over ``model`` into a contiguous
    whole: the layers' backward then sees the layout it sees without the
    split (:func:`scatter_to_model`'s gathered gradient is strided, and
    a GEMM's rounding follows its operands' layout).  JAX's pin of the
    residual stream at a remat unit's exit."""
    return _SplitSequence.apply(x, tp)


def gather_sequence(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """The model ranks' sequence blocks side by side, in rank order: the
    whole stream, which every rank then uses alike (the Megatron
    operators leave its gradient whole and the same on every model rank),
    so the backward keeps this rank's block of it, a copy.  The inverse
    of :func:`split_sequence`: JAX's pin at a remat unit's entry."""
    return _GatherSequence.apply(x, tp)
