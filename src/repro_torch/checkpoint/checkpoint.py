"""Atomic, mesh-agnostic checkpoints (port of
``repro/checkpoint/checkpoint.py``), in the JAX package's on-disk format
byte for byte, so either package restores the other's.

Layout::

    <dir>/step_<N>/
        manifest.json      # {"step", "extra", "leaves": [{"file", "path",
                           #   "shape", "dtype"}]}
        <idx:05d>.npy      # one file a leaf (host layout, unsharded)
    <dir>/LATEST           # text file with the last durable step

- **atomic**: written to ``step_<N>.tmp``, then renamed; ``LATEST`` is
  written to ``LATEST.tmp`` and renamed last.  A crash mid-save leaves
  the previous checkpoint whole.
- **mesh-agnostic**: leaves are stored whole; :func:`restore` keeps this
  rank's block of each (``shardings``, the partition specs of the mesh
  it now runs on), read through a memory map, so a job can restart on
  another topology and each rank reads only its blocks.
- **async**: :func:`save_async` copies the leaves to host memory now and
  writes them on one background thread.

A "tree" here is the list of ``(path, leaf)`` of ``jax.tree_util.
tree_flatten_with_path``: the path JAX's ``keystr`` of the leaf (for the
train state, ``train_step.state_leaves``), the leaves tensors or numpy
arrays, in JAX's flatten order.  A bfloat16 leaf is stored as float32
with ``"dtype": "bfloat16"`` and cast back on restore, as JAX does.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import sharding as shd

_EXEC = cf.ThreadPoolExecutor(max_workers=1)

Tree = Sequence[Tuple[str, Any]]


def _file_path(path: str) -> str:
    """The manifest's ``path``: JAX's keystr made a file-name word."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(the numpy array to store, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:      # numpy has no bfloat16
            return leaf.to(torch.float32).numpy(), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Tree,
         extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(tree):
        arr, dtype = _host(leaf)
        fn = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"file": fn, "path": _file_path(path), "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def save_async(directory: str, step: int, tree: Tree,
               extra: Optional[Dict[str, Any]] = None) -> cf.Future:
    """Copy the leaves to host memory now (a copy of a CPU tensor too:
    the trainer updates its optimizer state in place while the write
    runs); write on the background thread."""
    host = [(path, leaf.detach().to("cpu", copy=True)
             if isinstance(leaf, torch.Tensor) else np.array(leaf))
            for path, leaf in tree]
    return _EXEC.submit(save, directory, step, host, extra)


def latest_step(directory: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def restore(directory: str, tree_like: Tree, step: Optional[int] = None,
            shardings: Optional[Sequence[Sequence[Optional[str]]]] = None,
            mesh=None) -> Tuple[List[torch.Tensor], int, Dict[str, Any]]:
    """Restore into the leaves of ``tree_like``: returns (the leaves as
    tensors on the devices of ``tree_like``'s, the step, the extra dict).

    ``shardings``: one partition spec a leaf (e.g. the flat
    ``train_step.state_specs`` of the current ``mesh``); each leaf is then
    this rank's block of the stored one (elastic restart), read through
    a memory map.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if len(tree_like) != len(manifest["leaves"]):
        raise ValueError(f"{len(tree_like)} leaves to restore, the "
                         f"checkpoint holds {len(manifest['leaves'])}")
    out = []
    for i, (m, (path, like)) in enumerate(zip(manifest["leaves"],
                                              tree_like)):
        if m["path"] != _file_path(path):
            raise ValueError(f"leaf {i} is {m['path']} in the checkpoint, "
                             f"{_file_path(path)} here")
        arr = np.load(os.path.join(d, m["file"]), mmap_mode="r")
        if shardings is not None:
            arr = shd.local_slice(arr, shardings[i], mesh)
        t = torch.from_numpy(np.array(arr))
        if m["dtype"] == "bfloat16":
            t = t.to(torch.bfloat16)
        out.append(t.to(like.device))
    return out, manifest["step"], manifest["extra"]
