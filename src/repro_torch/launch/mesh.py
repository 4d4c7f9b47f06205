"""Production mesh definitions (port of ``repro/launch/mesh.py``).

The JAX package's shapes and axis names, built as DeviceMeshes over the
default process group (:func:`repro_torch.sharding.make_mesh`), which
must hold exactly as many ranks as the mesh has points.  Single pod:
16 x 16 = 256 ranks (data, model).  Multi-pod: P pods x 256 with a
leading "pod" axis; "pod" composes with "data" for the gradient
reduction (DP = pod x data) and is the axis Celeris's lossy sync cares
about most (cross-pod DCI links are the slow, lossy hops).

Functions, so importing this module touches no process group;
:func:`init_ranks` joins the one ``torch.distributed.run`` describes,
for the train and serve launchers alike.  The JAX module's hardware
table is a TPU's and has no counterpart here.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device
from repro_torch import sharding as shd


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shd.make_mesh(shape, axes, device_type)


def make_scale_mesh(n_devices: int, device_type: str = "cuda") -> DeviceMesh:
    """Scale-out mesh: 256 stays the single-pod (data, model) layout;
    512/1024/... stack pods of 16 x 16 (pod, data, model), so the DP
    group the lossy gradient sync reduces over is pod x data =
    n_devices / 16."""
    if n_devices == 256:
        return shd.make_mesh((16, 16), ("data", "model"), device_type)
    if n_devices % 256 or n_devices < 512:
        raise ValueError(f"n_devices={n_devices} must be 256 or a "
                         "multiple of 256 >= 512")
    return shd.make_mesh((n_devices // 256, 16, 16),
                         ("pod", "data", "model"), device_type)


def make_host_mesh(shape=(4, 2), axes=("data", "model"),
                   device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for a few ranks on one host."""
    return shd.make_mesh(shape, axes, device_type)


def make_pod_mesh(n_pods: int, data: int = 16, model: int = 16,
                  device_type: str = "cuda") -> DeviceMesh:
    """An N-pod (pod, data, model) mesh at any per-pod size: the
    production shape is ``make_pod_mesh(P)`` = P x 16 x 16; small
    ``data``/``model`` give host-scale hierarchical meshes, e.g.
    ``make_pod_mesh(2, 2, 1)`` on 4 ranks."""
    if n_pods < 2:
        raise ValueError(f"n_pods={n_pods}: a hierarchical mesh needs >= 2 "
                         "pods (use make_production_mesh for one pod)")
    return shd.make_mesh((n_pods, data, model), ("pod", "data", "model"),
                         device_type)


def init_ranks(device: str) -> tuple[str, str]:
    """Join the process group that ``torch.distributed.run`` describes
    (``env://``).  Returns (backend, this rank's device)."""
    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world:
        backend, rank_dev = "nccl", f"cuda:{local}"
    elif dev.type == "cuda":
        backend = "gloo"
        rank_dev = f"cuda:{local % torch.cuda.device_count()}"
    else:
        backend, rank_dev = "gloo", "cpu"
    if dev.type == "cuda":
        torch.cuda.set_device(torch.device(rank_dev))
    dist.init_process_group(backend, init_method="env://")
    return backend, rank_dev
