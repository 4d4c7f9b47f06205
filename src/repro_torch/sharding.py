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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MODEL_AXIS = "model"
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
    return tuple(a for a in mesh.mesh_dim_names if a in (POD_AXIS, "data"))


def peer_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-major index along ``axes``, in mesh order: the
    JAX island's ``peer`` (a P(dp)-sharded arange)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    idx = 0
    for a in (a for a in mesh.mesh_dim_names if a in axes):
        idx = idx * sizes[a] + coord[a]
    return idx


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
