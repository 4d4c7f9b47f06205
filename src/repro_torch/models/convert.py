"""Carry JAX parameters across to the port.

Takes the JAX package's parameter tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
The scanned ``decoder.groups[0]`` leaves, stacked over layers, are
unstacked into ``layers.{i}.*``; padded ``wq``/``wo`` and the leaves'
dtypes (bfloat16, float32) are kept as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.models.model import Params


def _tensor(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Dict[str, Any], prefix: str = ""
             ) -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def params_from_jax(tree: Dict[str, Any]) -> Params:
    """State dict (CPU tensors) from a JAX ``init_params`` tree of numpy
    leaves.  Only ``block_pattern=("global",)`` decoders are ported."""
    if set(tree) != {"embed", "decoder", "final_norm"}:
        raise NotImplementedError(f"unported parameter groups: {sorted(tree)}")
    groups, tail = tree["decoder"]["groups"], tree["decoder"]["tail"]
    if len(groups) != 1 or tail:
        raise NotImplementedError("only block_pattern=('global',) is ported")
    out: Params = {}
    for name, leaf in _flatten({"embed": tree["embed"],
                                "final_norm": tree["final_norm"]}):
        out[name] = _tensor(leaf)
    for name, leaf in _flatten(groups[0]):
        stacked = _tensor(leaf)
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{name}"] = stacked[i].clone()
    return out
