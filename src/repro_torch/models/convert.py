"""Carry JAX parameters across to the port, and the JAX leaf view.

Takes the JAX package's parameter tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
The scanned ``decoder.groups[0]`` leaves, stacked over layers, are
unstacked into ``layers.{i}.*``; padded ``wq``/``wo`` and the leaves'
dtypes (bfloat16, float32) are kept as they are.

The **JAX leaf view** (:func:`jax_leaves`, :func:`params_from_leaves`)
is the list of the JAX parameter tree's 14 leaves in
``jax.tree_util.tree_flatten`` order, per-layer entries stacked over
layers as the scanned ``decoder.groups[0]`` holds them.  The trainer
keeps its parameters in this view: the JAX train step plans, codes and
draws one mask and one set of signs per leaf index, so the port codes
the same stacked leaves in the same order.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence, Tuple

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


# The JAX tree's leaves in tree_flatten order (dict keys sorted at every
# level): decoder.groups[0].* stacked over layers, then embed, final_norm.
LAYER_LEAVES = ("attn.bk", "attn.bq", "attn.bv", "attn.wk", "attn.wo",
                "attn.wq", "attn.wv", "ln1.scale", "ln2.scale", "mlp.wg",
                "mlp.wi", "mlp.wo")
LEAF_NAMES = tuple(f"decoder.groups[0].{n}" for n in LAYER_LEAVES) + (
    "embed.table", "final_norm.scale")


def jax_leaves(params: Params) -> List[torch.Tensor]:
    """Per-layer state dict -> the 14 JAX leaves (new stacked tensors)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in params
                       if k.startswith("layers."))
    out = [torch.stack([params[f"layers.{i}.{n}"] for i in range(n_layers)])
           for n in LAYER_LEAVES]
    return out + [params["embed.table"], params["final_norm.scale"]]


def params_from_leaves(leaves: Sequence[torch.Tensor]) -> Params:
    """The 14 JAX leaves -> per-layer state dict of views into them
    (``unbind``: autograd gathers the layers' gradients back into one
    stacked gradient per leaf)."""
    if len(leaves) != len(LEAF_NAMES):
        raise ValueError(f"expected {len(LEAF_NAMES)} leaves, "
                         f"got {len(leaves)}")
    out: Params = {"embed.table": leaves[-2],
                   "final_norm.scale": leaves[-1]}
    for name, stacked in zip(LAYER_LEAVES, leaves):
        for i, layer in enumerate(stacked.unbind(0)):
            out[f"layers.{i}.{name}"] = layer
    return out
