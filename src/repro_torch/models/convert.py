"""Carry JAX parameters across to the port, and the JAX leaf view.

Takes the JAX package's parameter tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
The scanned ``decoder.groups[j]`` leaves, stacked over pattern groups,
are unstacked into ``layers.{i}.*`` (layer ``i = g * plen + j``), then
the ``tail`` layers, and an enc-dec model's ``encoder`` stack likewise
into ``encoder.layers.{i}.*``; padded ``wq``/``wo`` and the leaves'
dtypes (bfloat16, float32) are kept as they are.

The **JAX leaf view** (:func:`jax_leaves`, :func:`params_from_leaves`)
is the list of the JAX parameter tree's leaves in
``jax.tree_util.tree_flatten`` order (dict keys sorted at every level),
built from the config for every family: the ``decoder`` stack (per
position j of the block pattern the leaves of ``decoder.groups[j]``,
stacked over the ``n_layers // plen`` groups, group j's g-th slice layer
``g * plen + j``, then one layer a ``decoder.tail[t]``), then
``embed.table``, ``embed.unembed`` when untied, an enc-dec model's
``enc_norm.scale`` and its ``encoder`` stack (the same layout, its layers
``encoder.layers.{i}.*``), ``final_norm.scale`` and a frontend's
``frontend_proj``.  A layer's leaves follow its config: QKV biases only
with ``qkv_bias``, the post-norms ``pn1``/``pn2`` with ``post_norm``, no
``mlp.wg`` for squared ReLU, the MoE leaves (``moe.shared.*`` only with
shared experts), an enc-dec decoder layer's ``xattn.*`` and ``lnx``, the
recurrent blocks' ``rglru.*`` (with ``ln2`` and the MLP), ``mlstm.*`` and
``slstm.*`` (``ln1`` only, no MLP).  So qwen2 has 14 leaves, qwen2-moe 18,
gemma2 2 x 11 + 2, chatglm3 15, nemotron 11, granite-moe 12,
recurrentgemma 71 at 5 layers or more, xlstm 36, phi-3-vision 13,
seamless 27.  :func:`leaf_names`, :func:`short_names` and
:func:`leaf_shapes` give the view of a config; the functions that take
``names`` take :func:`leaf_names`, the two above the config itself.  The
trainer keeps its parameters in this view: the JAX train step plans,
codes and draws one mask and one set of signs per leaf index, so the
port codes the same stacked leaves in the same order.

On a mesh with a ``model`` axis each rank holds its slice of every leaf
that the partition specs split over ``model`` (:func:`shard_leaves`;
:func:`gather_leaves` puts them back together), and the whole of every
other leaf.  On a ``data`` axis larger than 1 it holds only its ZeRO-1
slice of the optimizer state (:func:`data_group` names each leaf's
dimension); :func:`gather_state` rebuilds a whole state leaf by leaf for
a checkpoint, which stays in host layout and so restores on any mesh.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as MOE
from repro_torch.models.model import ATTN_KINDS, Params
from repro_torch.train import sharding_rules as rules


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


# the parts of a block: dense, MoE, recurrent, and an enc-dec decoder
# block's cross-attention (xattn, lnx)
BLOCK_PARTS = ("attn", "ln1", "ln2", "mlp", "moe", "pn1", "pn2", "rglru",
               "mlstm", "slstm", "xattn", "lnx")
# the top-level groups: every model's, an enc-dec model's encoder, a
# frontend's projection
GROUPS = ("embed", "decoder", "final_norm", "encoder", "enc_norm",
          "frontend_proj")


def params_from_jax(tree: Dict[str, Any]) -> Params:
    """State dict (CPU tensors) from a JAX ``init_params`` tree of numpy
    leaves, for any family.  Each stack (``decoder`` into ``layers.*``,
    an enc-dec model's ``encoder`` into ``encoder.layers.*``) is
    unstacked (:func:`_unstack`); ``embed.unembed``, the post-norms,
    the nested ``moe`` group (``moe.shared.*`` included, the
    (n_groups, E, d, f) expert leaves unstacked), the recurrent blocks
    (``rglru.*``, ``mlstm.*``, ``slstm.*`` with their float32 gate
    leaves), the cross-attention (``xattn.*``, ``lnx.scale``),
    ``enc_norm`` and ``frontend_proj`` come across.  bfloat16 stays bit
    for bit."""
    groups = sorted(set(tree) - set(GROUPS))
    if groups:
        raise NotImplementedError(f"unknown parameter groups: {groups}")
    out: Params = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k not in ("decoder", "encoder")}):
        out[name] = _tensor(leaf)
    out.update(_unstack(tree["decoder"], "layers."))
    if "encoder" in tree:
        out.update(_unstack(tree["encoder"], "encoder.layers."))
    return out


def _unstack(stack: Dict[str, Any], prefix: str) -> Params:
    """One scanned stack (``groups``, stacked over pattern groups, then
    ``tail``) -> ``{prefix}{i}.*``: layer ``i < n_groups * plen`` is
    ``groups[i % plen][i // plen]``, the rest the ``tail`` in order."""
    groups, tail = stack["groups"], stack["tail"]
    blocks = [b for b in list(groups) + list(tail) if b is not None]
    parts = sorted({k for b in blocks for k in b} - set(BLOCK_PARTS))
    if parts:
        raise NotImplementedError(f"unknown block parts: {parts}")
    out: Params = {}
    plen, n = len(groups), 0
    for j, group in enumerate(groups):
        if group is None:          # fewer layers than the pattern
            continue
        for name, leaf in _flatten(group):
            stacked = _tensor(leaf)
            n = stacked.shape[0] * plen
            for g in range(stacked.shape[0]):
                out[f"{prefix}{g * plen + j}.{name}"] = stacked[g].clone()
    for t, block in enumerate(tail):
        for name, leaf in _flatten(block):
            out[f"{prefix}{n + t}.{name}"] = _tensor(leaf)
    return out


def _tree_order(names) -> Tuple[str, ...]:
    """Dotted names in ``tree_flatten`` order: dict keys sorted at every
    level (``moe.shared.wg`` before ``moe.wg``)."""
    return tuple(sorted(names, key=lambda n: n.split(".")))


def _layer_shapes(cfg: ModelConfig, kind: str, cross: bool = False
                  ) -> Dict[str, Tuple[int, ...]]:
    """One layer's leaves and shapes in the JAX leaf view, for a block of
    ``kind`` (JAX ``init_block``).  An attention block: the attention's
    ``w{q,k,v,o}``, with ``b{q,k,v}`` only under ``qkv_bias``;
    ``ln1``/``ln2``, with ``pn1``/``pn2`` under ``post_norm``; then the
    MLP (``wg``, ``wi``, ``wo``; no ``wg`` for squared ReLU), or for
    ``"moe"`` the MoE leaves (``moe.shared.*`` only with shared
    experts); ``cross`` (an enc-dec decoder layer) adds the
    cross-attention ``xattn.w{q,k,v,o}`` and its norm ``lnx``.  An
    rglru block: ``ln1``, ``ln2``, the MLP and the ten ``rglru.*``
    leaves; an mlstm or slstm block: ``ln1`` and its block's leaves,
    no MLP.  The shapes are the blocks' ``init_*`` ones (the gates,
    ``lam``, ``w_if``, ``b_if``, ``b`` and ``r_h`` are float32 there)."""
    d = cfg.d_model
    if kind == "rglru":
        w, kw = cfg.lru_width or d, cfg.rglru_conv_width
        layer = {f"rglru.{n}": (w,) for n in (
            "conv_b", "gate_a_b", "gate_a_w", "gate_x_b", "gate_x_w", "lam")}
        layer.update({"rglru.conv_w": (kw, w), "rglru.w_gate": (d, w),
                      "rglru.w_in": (d, w), "rglru.w_out": (w, d),
                      "ln1.scale": (d,), "ln2.scale": (d,)})
        return dict(layer, **_mlp_shapes(cfg))
    if kind == "mlstm":
        di, hh = 2 * d, cfg.n_heads
        return {"ln1.scale": (d,), "mlstm.b_if": (2 * hh,),
                "mlstm.w_down": (di, d), "mlstm.w_gate": (d, di),
                "mlstm.w_if": (di, 2 * hh), "mlstm.w_up": (d, di),
                "mlstm.wk": (di, di), "mlstm.wq": (di, di),
                "mlstm.wv": (di, di)}
    if kind == "slstm":
        hh = cfg.n_heads
        dh = d // hh
        return {"ln1.scale": (d,), "slstm.b": (4 * d,),
                "slstm.r_h": (hh, dh, 4 * dh), "slstm.w_down": (2 * d, d),
                "slstm.w_up1": (d, 2 * d), "slstm.w_up2": (d, 2 * d),
                "slstm.w_x": (d, 4 * d)}
    if kind not in ATTN_KINDS:
        raise ValueError(f"{cfg.name}: no block of kind {kind!r}")
    layer = {"ln1.scale": (d,), "ln2.scale": (d,)}
    layer.update(_attn_shapes(cfg, "attn."))
    if cfg.post_norm:
        layer.update({"pn1.scale": (d,), "pn2.scale": (d,)})
    if cross:
        layer.update(_attn_shapes(cfg, "xattn."))
        layer["lnx.scale"] = (d,)
    if kind != "moe":
        return dict(layer, **_mlp_shapes(cfg))
    e, fe = MOE.padded_experts(cfg), cfg.moe.d_expert
    layer.update({"moe.router": (d, e), "moe.wg": (e, d, fe),
                  "moe.wi": (e, d, fe), "moe.wo": (e, fe, d)})
    if cfg.moe.n_shared:
        fs = cfg.moe.n_shared * fe
        layer.update({"moe.shared.wg": (d, fs), "moe.shared.wi": (d, fs),
                      "moe.shared.wo": (fs, d)})
    return layer


def _attn_shapes(cfg: ModelConfig, pre: str) -> Dict[str, Tuple[int, ...]]:
    """An attention's leaves under ``pre`` (``attn.`` or ``xattn.``)."""
    d = cfg.d_model
    q = cfg.n_heads_padded * cfg.resolved_head_dim
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    out = {"wk": (d, kv), "wo": (q, d), "wq": (d, q), "wv": (d, kv)}
    if cfg.qkv_bias:
        out.update({"bk": (kv,), "bq": (q,), "bv": (kv,)})
    return {pre + n: shape for n, shape in out.items()}


def _mlp_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, f = cfg.d_model, cfg.d_ff
    out = {"mlp.wi": (d, f), "mlp.wo": (f, d)}
    if cfg.mlp_type != "sqrelu":
        out["mlp.wg"] = (d, f)
    return out


class _Leaf(NamedTuple):
    """One leaf of the view: JAX's path (``decoder.groups[0].attn.wq``),
    its name in a layer's params (``attn.wq``), its global shape, the
    layers it holds as their params' prefixes (``layers.3.``,
    ``encoder.layers.0.``; a group leaf's, stacked in dim 0; a tail
    leaf's one; None for a top-level leaf) and whether they are
    stacked."""
    path: str
    short: str
    shape: Tuple[int, ...]
    layers: Optional[Tuple[str, ...]]
    stacked: bool


def _stack_view(cfg: ModelConfig, stack: str, prefix: str, n_layers: int,
                cross: bool = False) -> List[_Leaf]:
    """The leaves of one scanned stack (JAX ``_init_stack``), ``stack``
    its JAX key (``decoder``, ``encoder``) and ``prefix`` its layers'
    in the params: ``{stack}.groups[j].*`` for each position j of the
    pattern (stacked over the n_layers // plen groups: slice g is layer
    g * plen + j), then ``{stack}.tail[t].*`` (layer n_groups * plen +
    t)."""
    plen = len(cfg.block_pattern)
    n_groups, tail = n_layers // plen, cfg.block_pattern[:n_layers % plen]
    groups = cfg.block_pattern if n_groups else ()
    out = []
    for j, kind in enumerate(groups):
        layer = _layer_shapes(cfg, kind, cross)
        out += [_Leaf(f"{stack}.groups[{j}].{n}", n, (n_groups,) + layer[n],
                      tuple(f"{prefix}{g * plen + j}."
                            for g in range(n_groups)), True)
                for n in _tree_order(layer)]
    for t, kind in enumerate(tail):
        layer = _layer_shapes(cfg, kind, cross)
        out += [_Leaf(f"{stack}.tail[{t}].{n}", n, layer[n],
                      (f"{prefix}{n_groups * plen + t}.",), False)
                for n in _tree_order(layer)]
    return out


def _view(cfg: ModelConfig) -> List[_Leaf]:
    """The JAX leaf view of ``cfg``, in ``tree_flatten`` order (keys
    sorted at the top too): the ``decoder`` stack (:func:`_stack_view`;
    an enc-dec model's layers with their cross-attention),
    ``embed.table``, ``embed.unembed`` when untied, an enc-dec model's
    ``enc_norm.scale`` and ``encoder`` stack, ``final_norm.scale``, and a
    frontend's ``frontend_proj``."""
    d, v = cfg.d_model, cfg.vocab_size
    top = {"embed.table": (v, d), "final_norm.scale": (d,)}
    if not cfg.tie_embeddings:
        top["embed.unembed"] = (d, v)
    if cfg.is_encdec:
        top["enc_norm.scale"] = (d,)
    if cfg.frontend:
        top["frontend_proj"] = (cfg.frontend_dim, d)
    out = _stack_view(cfg, "decoder", "layers.", cfg.n_layers,
                      cross=cfg.is_encdec)
    out += [_Leaf(n, n, top[n], None, False)
            for n in _tree_order(top) if n < "encoder"]
    if cfg.is_encdec:
        out += _stack_view(cfg, "encoder", "encoder.layers.",
                           cfg.encoder_layers)
    return out + [_Leaf(n, n, top[n], None, False)
                  for n in _tree_order(top) if n > "encoder"]


def leaf_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The JAX tree's leaf paths of ``cfg``'s view, in leaf order."""
    return tuple(leaf.path for leaf in _view(cfg))


def short_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The same leaves by their names in a layer's (or the model's)
    params: ``attn.wq`` for every group's and tail layer's ``wq``, so a
    name may repeat (gemma2's two groups)."""
    return tuple(leaf.short for leaf in _view(cfg))


def leaf_shapes(cfg: ModelConfig) -> List[Tuple[int, ...]]:
    """The JAX leaves' global shapes for ``cfg``, in leaf order."""
    return [leaf.shape for leaf in _view(cfg)]


def jax_leaves(params: Params, cfg: ModelConfig) -> List[torch.Tensor]:
    """Per-layer state dict -> ``cfg``'s JAX leaves (new stacked
    tensors): group j's leaf stacks layers j, j + plen, ..., a tail leaf
    is its layer's, as ``params_from_jax`` unstacks them."""
    out = []
    for leaf in _view(cfg):
        if leaf.layers is None:
            out.append(params[leaf.path])
            continue
        layers = [params[pre + leaf.short] for pre in leaf.layers]
        out.append(torch.stack(layers) if leaf.stacked else layers[0])
    return out


def params_from_leaves(leaves: Sequence[torch.Tensor], cfg: ModelConfig
                       ) -> Params:
    """``cfg``'s JAX leaves -> per-layer state dict of views into them
    (``unbind``: autograd gathers the layers' gradients back into one
    stacked gradient per leaf)."""
    view = _view(cfg)
    if len(leaves) != len(view):
        raise ValueError(f"{len(leaves)} leaves for {len(view)} names")
    out: Params = {}
    for leaf, x in zip(view, leaves):
        if leaf.layers is None:
            out[leaf.path] = x
            continue
        layers = x.unbind(0) if leaf.stacked else (x,)
        for pre, layer in zip(leaf.layers, layers, strict=True):
            out[pre + leaf.short] = layer
    return out


def split_dims(shapes: Sequence[Sequence[int]], mesh,
               names: Sequence[str]) -> List[Optional[int]]:
    """Each leaf's dim on the ``model`` axis of this mesh (split when the
    axis is larger than 1), or None, from the leaves' global shapes and
    paths (:func:`leaf_names`)."""
    return [rules.sharded_dim(spec)
            for spec in rules.param_specs(shapes, mesh, names)]


def model_group(cfg: ModelConfig, mesh) -> Optional[shd.ModelGroup]:
    """This rank's :class:`~repro_torch.sharding.ModelGroup` with the
    leaves of ``cfg`` that the specs split over ``model``
    (:func:`short_names`), which the layers read; None without tensor
    parallelism."""
    tp = shd.model_group(mesh)
    if tp is None:
        return None
    dims = split_dims(leaf_shapes(cfg), mesh, leaf_names(cfg))
    split = {n for n, d in zip(short_names(cfg), dims) if d is not None}
    kept = {n for n, d in zip(short_names(cfg), dims) if d is None}
    if split & kept:   # a layer reads one short name for every group's leaf
        raise ValueError(f"{cfg.name}: {sorted(split & kept)} split in one "
                         "group and whole in another")
    return dataclasses.replace(tp, split=frozenset(split))


def data_group(cfg: ModelConfig, mesh) -> Optional[shd.DataGroup]:
    """This rank's :class:`~repro_torch.sharding.DataGroup` with each leaf
    of ``cfg``'s dimension that the ZeRO-1 specs split over ``data``
    (None for a leaf kept whole), which the optimizer reads; None
    without ZeRO-1 (no ``data`` axis larger than 1)."""
    dg = shd.data_group(mesh)
    if dg is None:
        return None
    specs = rules.zero1_specs(leaf_shapes(cfg), mesh, leaf_names(cfg))
    return dataclasses.replace(dg, dims=tuple(
        s.index(shd.DATA_AXIS) if shd.DATA_AXIS in s else None
        for s in specs))


def gather_state(leaves: Sequence[torch.Tensor], specs, mesh
                 ) -> Iterator[torch.Tensor]:
    """This rank's state leaves, placed by ``specs`` (e.g. the flat
    ``train_step.state_specs``) -> the whole leaves, one at a time, so
    that one whole leaf at a time is on the device: each leaf gathered
    over ``data`` (ZeRO-1), then over ``model``.  Every rank of the mesh
    iterates it together."""
    dg, tp = shd.data_group(mesh), shd.model_group(mesh)
    for x, spec in zip(leaves, specs):
        if dg is not None and shd.DATA_AXIS in spec:
            x = shd.data_all_gather(x, dg, spec.index(shd.DATA_AXIS))
        if tp is not None and shd.MODEL_AXIS in spec:
            dim = spec.index(shd.MODEL_AXIS)
            x = (shd.model_all_gather(x.movedim(dim, -1), tp)
                 .movedim(-1, dim).contiguous())
        yield x


def shard_leaves(leaves: Sequence[Any], mesh,
                 names: Sequence[str]) -> List[torch.Tensor]:
    """The full JAX leaves (numpy arrays or tensors) named ``names``
    (:func:`leaf_names`) -> this rank's leaves: its slice of each leaf
    that the partition specs split over ``model``, copies of the rest.
    A leaf that the divisibility guard keeps whole stays whole."""
    leaves = [x if isinstance(x, torch.Tensor) else _tensor(x)
              for x in leaves]
    if shd.model_group(mesh) is None:
        return [x.clone() for x in leaves]
    specs = rules.param_specs([x.shape for x in leaves], mesh, names)
    return [shd.local_slice(x, s, mesh).clone()
            for x, s in zip(leaves, specs)]


def gather_leaves(shards: Sequence[torch.Tensor], mesh,
                  shapes: Sequence[Sequence[int]],
                  names: Sequence[str]) -> List[torch.Tensor]:
    """Inverse of :func:`shard_leaves`, given the leaves' global
    ``shapes`` (e.g. :func:`leaf_shapes`; a shard alone cannot tell a
    split leaf from one the guard kept whole): every model rank calls it
    together and gets the full leaves back, each split leaf all-gathered
    over the ``model`` group."""
    return list(gather_state(shards, rules.param_specs(shapes, mesh, names),
                             mesh))
