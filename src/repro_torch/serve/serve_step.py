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
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import coding
from repro_torch.models import layers as L
from repro_torch.models import model as M

Signs = Union[torch.Tensor, Sequence[torch.Tensor]]


def frontend_inputs(cfg: ModelConfig, batch: int, seq: int,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The frontend stub's inputs, shaped as the JAX package's
    ``launch/specs.token_extras``: a vision stub's ``image_embeds``
    (batch, n_frontend_tokens, frontend_dim), an audio stub's
    ``frame_embeds`` (batch, seq, frontend_dim); standard normal from
    ``generator``, on its device, in bfloat16.  Empty without a
    frontend."""
    dev = generator.device
    shape = {"vision_stub": (batch, cfg.n_frontend_tokens, cfg.frontend_dim),
             "audio_stub": (batch, seq, cfg.frontend_dim)}.get(cfg.frontend)
    if shape is None:
        return {}
    name = "image_embeds" if cfg.frontend == "vision_stub" else "frame_embeds"
    return {name: torch.randn(shape, generator=generator, device=dev
                              ).to(torch.bfloat16)}


def make_prefill(cfg: ModelConfig, s_max: int):
    def prefill(params: M.Params, tokens: torch.Tensor, *,
                image_embeds: Optional[torch.Tensor] = None,
                frame_embeds: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None):
        """Prefill positions 0 .. n_front + S - 1: a vision stub's image
        positions first (``cfg.n_front``), then the text.  An enc-dec
        model takes its encoder's ``memory``, or ``frame_embeds`` to
        encode."""
        if cfg.n_front and image_embeds is None:
            raise ValueError(f"{cfg.name} prefills with image_embeds")
        caches = M.init_caches(cfg, tokens.shape[0], s_max, tokens.device)
        positions = torch.arange(cfg.n_front + tokens.shape[1],
                                 device=tokens.device)[None, :]
        logits = M.forward(params, cfg, tokens, caches=caches,
                           positions=positions, last_only=True,
                           image_embeds=image_embeds,
                           frame_embeds=frame_embeds, memory=memory)
        return logits[:, -1], caches
    return prefill


def make_decode(cfg: ModelConfig):
    def decode(params: M.Params, caches: M.Caches, tokens: torch.Tensor,
               index: int, memory: Optional[torch.Tensor] = None):
        """index: the position being generated.  Writes into ``caches``.
        ``memory``: an enc-dec model's encoder output, which its
        cross-attention reads (no cross cache: K/V from it each step)."""
        positions = torch.full((tokens.shape[0], 1), index,
                               device=tokens.device)
        logits = M.forward(params, cfg, tokens, caches=caches,
                           cache_index=index, positions=positions,
                           memory=memory)
        return logits[:, -1], caches
    return decode


def greedy_decode(cfg: ModelConfig, params: M.Params, caches: M.Caches,
                  first_token: torch.Tensor, start_idx: int,
                  n_steps: int, memory: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Greedy host-loop decode from an existing (possibly degraded) KV
    cache: ``first_token`` (B, 1) seeds the loop, ``start_idx`` is the
    cache position of the first generated token.  Returns (B, n_steps)
    tokens including ``first_token``.  Consumes ``caches``.  ``memory``
    reaches every step; JAX's loop passes none (``serve_step.py:70``),
    which ``memory=None`` keeps: an enc-dec model then decodes without
    its cross-attention."""
    decode = make_decode(cfg)
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


def kv_position_error(clean: M.Caches, degraded: M.Caches,
                      n_ctx: int) -> torch.Tensor:
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
    """
    leaves0, leaves1 = clean.leaves(), degraded.leaves()
    dev = clean.device
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
    return torch.sqrt(err2 / torch.clamp(ref2, min=1e-12))
