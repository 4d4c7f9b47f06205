"""Serving: prefill, decode, and decode from KV caches shipped through
the lossy transport (port of ``repro/serve/serve_step.py``).

- ``make_prefill``: (params, tokens (B, S), frontend inputs) -> (last-
  position logits, caches).
- ``make_decode``: (params, caches, tokens (B, 1), index, memory) ->
  (logits, caches): one new token written into the caches in place at
  ``index``.
- ``degrade_caches``: the prefill -> decode KV transfer under wire-row
  loss, coded (Hadamard, through the FWHT and unbias kernels on the
  card) or uncoded: every K and V leaf of the cache tree
  (``Caches.leaves()``) ships as its own payload; recurrent state
  (recurrentgemma's RG-LRU layers, xLSTM's) is not coded, and an enc-dec
  model's encoder ``memory`` is no cache at all: it is not shipped.

PyTorch runs eagerly, so the factories return plain closures where the
JAX package returns jitted functions.

On a (data, model) mesh (JAX's ``serve_step.py:10-14``: the batch over
the dp axes, the parameters tensor parallel over ``model``) each rank
holds its ``convert.shard_leaves`` and its rows of the batch
(:func:`local_batch`), and the factories take its groups
(:func:`mesh_groups`): ``tp`` runs the layers tensor parallel, its
caches laid out as ``model.init_caches(tp=)`` says, and ``rows`` routes
the dp ranks' rows together through the MoE layers, as JAX's serving jit
routes the global batch.  Logits split over the vocabulary are gathered
over ``model`` before anyone takes their argmax.  Each rank ships its
own K/V slices (:func:`degrade_caches`), and :func:`kv_position_error`
reports the one-device value from them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

import repro_torch
from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.core import coding
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import sharding_rules as rules

Signs = Union[torch.Tensor, Sequence[torch.Tensor]]


def frontend_inputs(cfg: ModelConfig, batch: int, seq: int,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The frontend stub's inputs, shaped as the JAX package's
    ``launch/specs.token_extras``: a vision stub's ``image_embeds``
    (batch, n_frontend_tokens, frontend_dim), an audio stub's
    ``frame_embeds`` (batch, seq, frontend_dim); standard normal from
    ``generator``, on its device, in bfloat16.  Empty without a
    frontend."""
    shape = {"vision_stub": (batch, cfg.n_frontend_tokens, cfg.frontend_dim),
             "audio_stub": (batch, seq, cfg.frontend_dim)}.get(cfg.frontend)
    if shape is None:
        return {}
    name = "image_embeds" if cfg.frontend == "vision_stub" else "frame_embeds"
    return {name: repro_torch.randn(shape, generator).to(torch.bfloat16)}


def mesh_groups(cfg: ModelConfig, mesh
                ) -> tuple[Optional[shd.ModelGroup], Optional[shd.RowGroup]]:
    """(tp, rows) of this rank on ``mesh``: its model group with the
    leaves of ``cfg`` the specs split (``convert.model_group``; None
    without a ``model`` axis larger than 1), and the dp ranks whose rows
    it serves beside its own (a :class:`~repro_torch.sharding.RowGroup`
    over the dp axes; None when they hold one rank).  Every rank calls it
    together (the groups are collective)."""
    tp = convert.model_group(cfg, mesh)
    dp = shd.dp_axes(mesh)
    n = shd.axis_size(mesh, dp)
    rows = (shd.RowGroup(shd.group(mesh, dp), n, shd.peer_index(mesh, dp))
            if n > 1 else None)
    return tp, rows


def local_batch(mesh, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (the prompt, the frontend
    inputs): block ``i`` of the rows for its row-major dp index ``i``,
    placed by ``sharding_rules.batch_specs``; the dp ranks must divide
    the rows."""
    n = shd.axis_size(mesh, shd.dp_axes(mesh))
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over "
                             f"{n} dp ranks")
    specs = rules.batch_specs(mesh, batch)
    return {k: shd.local_slice(v, specs[k], mesh).contiguous()
            for k, v in batch.items()}


def whole_logits(logits: torch.Tensor, cfg: ModelConfig,
                 tp: Optional[shd.ModelGroup]) -> torch.Tensor:
    """Logits split over the vocabulary (``tp`` splitting
    ``model.logits_leaf``) gathered over ``model`` into the whole
    vocabulary, so that an argmax sees every row and a tie goes to the
    lowest index, as ``jnp.argmax`` on JAX's whole logits; else as
    they are."""
    vocab_tp = L.split_over_model(M.logits_leaf(cfg), tp)
    return (logits if vocab_tp is None
            else shd.model_all_gather(logits, vocab_tp))


def make_prefill(cfg: ModelConfig, s_max: int,
                 tp: Optional[shd.ModelGroup] = None,
                 rows: Optional[shd.RowGroup] = None):
    def prefill(params: M.Params, tokens: torch.Tensor, *,
                image_embeds: Optional[torch.Tensor] = None,
                frame_embeds: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None):
        """Prefill positions 0 .. n_front + S - 1: a vision stub's image
        positions first (``cfg.n_front``), then the text.  An enc-dec
        model takes its encoder's ``memory``, or ``frame_embeds`` to
        encode (tensor parallel with ``tp``: the memory comes out whole
        on every rank).  Returns the last position's logits over the
        whole vocabulary (:func:`whole_logits`) and the rank's caches."""
        if cfg.n_front and image_embeds is None:
            raise ValueError(f"{cfg.name} prefills with image_embeds")
        caches = M.init_caches(cfg, tokens.shape[0], s_max, tokens.device,
                               tp)
        positions = torch.arange(cfg.n_front + tokens.shape[1],
                                 device=tokens.device)[None, :]
        logits = M.forward(params, cfg, tokens, caches=caches,
                           positions=positions, last_only=True, tp=tp,
                           rows=rows, image_embeds=image_embeds,
                           frame_embeds=frame_embeds, memory=memory)
        return whole_logits(logits[:, -1], cfg, tp), caches
    return prefill


def make_decode(cfg: ModelConfig, tp: Optional[shd.ModelGroup] = None,
                rows: Optional[shd.RowGroup] = None):
    def decode(params: M.Params, caches: M.Caches, tokens: torch.Tensor,
               index: int, memory: Optional[torch.Tensor] = None):
        """index: the position being generated.  Writes into ``caches``.
        ``memory``: an enc-dec model's encoder output, which its
        cross-attention reads (no cross cache: K/V from it each step).
        The logits cover the whole vocabulary (:func:`whole_logits`)."""
        positions = torch.full((tokens.shape[0], 1), index,
                               device=tokens.device)
        logits = M.forward(params, cfg, tokens, caches=caches,
                           cache_index=index, positions=positions,
                           tp=tp, rows=rows, memory=memory)
        return whole_logits(logits[:, -1], cfg, tp), caches
    return decode


def greedy_decode(cfg: ModelConfig, params: M.Params, caches: M.Caches,
                  first_token: torch.Tensor, start_idx: int,
                  n_steps: int, memory: Optional[torch.Tensor] = None,
                  tp: Optional[shd.ModelGroup] = None,
                  rows: Optional[shd.RowGroup] = None) -> torch.Tensor:
    """Greedy host-loop decode from an existing (possibly degraded) KV
    cache: ``first_token`` (B, 1) seeds the loop, ``start_idx`` is the
    cache position of the first generated token.  Returns (B, n_steps)
    tokens including ``first_token``.  Consumes ``caches``.  ``memory``
    reaches every step; JAX's loop passes none (``serve_step.py:70``),
    which ``memory=None`` keeps: an enc-dec model then decodes without
    its cross-attention.  ``tp``/``rows``: a rank's groups on a mesh
    (:func:`mesh_groups`); B its rows."""
    decode = make_decode(cfg, tp, rows)
    out = [first_token]
    idx = start_idx
    for _ in range(n_steps - 1):
        logits, caches = decode(params, caches, out[-1], idx, memory)
        out.append(torch.argmax(logits, -1)[:, None])
        idx += 1
    return torch.cat(out, dim=1)


def greedy_generate(cfg: ModelConfig, params: M.Params, prompt: torch.Tensor,
                    n_steps: int, s_max: Optional[int] = None,
                    extra: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Small host-loop generator for examples/tests (greedy).  ``extra``:
    the frontend inputs (:func:`frontend_inputs`).  Decoding starts at
    position ``n_front + S``, after the positions the prefill wrote (JAX
    starts at S, ``serve_step.py:85``, so a vision model's first token
    overwrites slot S there), and ``s_max`` defaults to the positions
    written; an enc-dec model encodes once and every step reads the
    memory."""
    extra = dict(extra or {})
    start = cfg.n_front + prompt.shape[1]
    s_max = s_max or (start + n_steps)
    if cfg.is_encdec and "frame_embeds" in extra:
        extra["memory"] = M.encode(params, cfg, extra.pop("frame_embeds"))
    logits, caches = make_prefill(cfg, s_max)(params, prompt, **extra)
    first = torch.argmax(logits, -1)[:, None]
    return greedy_decode(cfg, params, caches, first, start, n_steps,
                         memory=extra.get("memory"))


# ----------------------------------------------------------------------
# Degraded-KV decode: ship caches through the lossy transport's wire
# layout (coupling.kv_hole_masks -> here)
# ----------------------------------------------------------------------

def kv_wire_roundtrip(flat: torch.Tensor, mask: torch.Tensor,
                      signs: torch.Tensor, code: coding.HadamardCode, *,
                      coded: bool = True) -> torch.Tensor:
    """One flat KV payload through the wire: encode (or just block),
    drop the wire rows where ``mask`` is 0, decode.

    ``mask`` (n_rot,) is one request's transport-block arrival mask.
    The payload ships as ``n_rot`` transport blocks either way and the
    same block indices are lost; what a block carries differs:

    - ``coded=True``: block ``j`` is wire row ``j`` of the Hadamard
      layout (coordinate ``j`` of every rotation block); lost rows are
      unbiased over by ``coding.decode``, so the damage is small dense
      noise across the whole payload.
    - ``coded=False``: block ``j`` is the ``j``-th contiguous chunk of
      the raw payload; lost chunks are holes, whole spans of cache
      positions zeroed.
    """
    mask = mask.to(flat.dtype)
    if coded:
        wire = coding.encode(flat, signs, code)
        wire = wire * mask[:, None]
        return coding.decode(wire, mask, signs, code, total_peers=1)
    x = F.pad(flat.reshape(-1), (0, code.padded_len - code.orig_len))
    chunks = x.reshape(code.n_rot, code.n_blocks) * mask[:, None]
    return chunks.reshape(-1)[: code.orig_len]


def degrade_caches(caches: M.Caches, mask: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   coded: bool = True,
                   signs: Optional[Signs] = None) -> M.Caches:
    """Apply one request's KV-transfer loss to its decode caches.

    Every K and V leaf (``caches.leaves()``: groups, then tail; ``k``
    before ``v``) is flattened and shipped as its own payload, with its
    own plan, through :func:`kv_wire_roundtrip` under the same wire-row
    mask, and a new cache is returned; positions and recurrent state are
    metadata the transport does not code, and are copied bit for bit.  A
    tree without K/V leaves (xLSTM) comes back as a copy, nothing drawn
    or launched, as JAX's ``tree_map`` leaves it.  The rotation signs: JAX
    draws each leaf's from the same key, and every leaf's plan has the
    mask's ``n_rot`` rows, so every leaf gets the same signs, drawn once
    from ``generator`` (prefill and decode sides seed it alike).  Tests
    pass ``signs`` instead: one tensor for every leaf, or one per leaf.

    On a mesh each rank calls it on its own caches: each of its K/V
    slices ships as a payload of its own, with its own plan, the
    request's mask and the shared signs.  The round trip acts on
    contiguous ``n_rot``-element blocks, element-wise after the
    rotation, so wherever a rank's blocks are blocks of the global leaf
    (its contiguous runs, ``(n_kv / tp) * head_dim`` and each dp block of
    rows, multiples of ``n_rot``) its result is bit for bit the matching
    slice of the one-device degrade of the whole leaf; elsewhere the
    rank's own coding is the definition.  Replicas of a whole leaf ship
    alike and stay bit-identical.
    """
    n_rot = int(mask.shape[0])
    leaves = caches.leaves()
    if not leaves:
        return caches.clone()
    dev = leaves[0].device
    mask = mask.to(dev)

    def _plan(leaf: torch.Tensor) -> coding.HadamardCode:
        code = coding.plan(leaf.numel(), n_rot=n_rot)
        if code.n_rot != n_rot:
            raise ValueError(
                f"KV leaf of {leaf.numel()} elements cannot carry a "
                f"{n_rot}-row wire mask (plan chose {code.n_rot})")
        return code

    if coded and signs is None:
        if generator is None:
            raise ValueError("coded degrade_caches needs a generator or signs")
        signs = coding.rademacher(generator, _plan(leaves[0])).to(dev)
    if not isinstance(signs, (list, tuple)):
        signs = [signs] * len(leaves)
    if len(signs) != len(leaves):
        raise ValueError(f"{len(signs)} sign vectors for {len(leaves)} "
                         "KV leaves")
    shipped = [
        kv_wire_roundtrip(leaf.reshape(-1).to(torch.float32), mask, sg,
                          _plan(leaf), coded=coded
                          ).reshape(leaf.shape).to(leaf.dtype)
        for leaf, sg in zip(leaves, signs)]

    kv = iter(shipped)

    def _node(c: L.StateCache) -> L.StateCache:
        if not isinstance(c, L.AttnCache):
            return c.clone()
        return L.AttnCache(k=next(kv), v=next(kv), pos=c.pos.clone())

    nodes = [_node(c) for c in caches.nodes()]
    n = len(caches.groups)
    return M.Caches(groups=nodes[:n], tail=nodes[n:])


def kv_wire_bytes(caches: M.Caches, n_rot: int) -> int:
    """The bytes :func:`degrade_caches` puts on the wire for ``caches``
    (a rank's, on a mesh): each K/V leaf's float32 wire layout, its
    plan's ``n_rot`` rows of padded blocks."""
    return sum(4 * coding.plan(leaf.numel(), n_rot=n_rot).padded_len
               for leaf in caches.leaves())


def kv_position_error(clean: M.Caches, degraded: M.Caches,
                      n_ctx: int, cfg: Optional[ModelConfig] = None,
                      tp: Optional[shd.ModelGroup] = None,
                      rows: Optional[shd.RowGroup] = None) -> torch.Tensor:
    """(n_ctx,) per-position relative KV error after lossy transfer.

    For each cache position ``s < n_ctx``, the relative L2 error of its
    K/V vectors summed over every leaf (every layer).  An uncoded lost
    chunk drives whole positions to error ~1; the coded path spreads the
    same loss as small noise over all positions.  The share of positions
    under an error threshold is fig8's usable-context fraction.  A leaf
    with fewer than ``n_ctx`` slots (a local layer's ring that wrapped:
    slot is position mod its size) has no position axis: ValueError,
    where the JAX function fails in its reshape.  A tree without K/V
    leaves (xLSTM) has no error: zeros, as JAX's ``sqrt(0 / 1e-12)``.

    On a mesh (a rank's caches of ``cfg``, its groups ``tp`` and
    ``rows``): the sums of the K/V slices split over ``model``
    (``model.cache_split_dims``) add up over ``model``, whole ones count
    once, and both add up over the dp ranks' rows, so every rank reports
    the one-device value (to float32 rounding of the sums' order).
    """
    leaves0, leaves1 = clean.leaves(), degraded.leaves()
    dev = clean.device
    split = tp is not None and bool(M.cache_split_dims(cfg, tp)["global"])
    err2 = torch.zeros(n_ctx, device=dev)
    ref2 = torch.zeros(n_ctx, device=dev)
    for a0, a1 in zip(leaves0, leaves1):
        # (..., B, S, KV, Dh): fold everything but the slot axis
        s_ax = a0.dim() - 3
        if a0.shape[s_ax] < n_ctx:
            raise ValueError(
                f"n_ctx {n_ctx} exceeds a {a0.shape[s_ax]}-slot KV leaf: a "
                "ring cache that wrapped has no position axis")
        d = torch.movedim((a1 - a0) ** 2, s_ax, 0)
        r = torch.movedim(a0.to(torch.float32) ** 2, s_ax, 0)
        err2 = err2 + d[:n_ctx].reshape(n_ctx, -1).sum(1)
        ref2 = ref2 + r[:n_ctx].reshape(n_ctx, -1).sum(1)
    sums = torch.stack([err2, ref2])
    if split:
        shd.model_all_reduce(sums, tp)
    if rows is not None:
        dist.all_reduce(sums, group=rows.group)
    return torch.sqrt(sums[0] / torch.clamp(sums[1], min=1e-12))
