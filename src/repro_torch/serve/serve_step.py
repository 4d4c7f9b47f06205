"""Serving: prefill, decode, and decode from KV caches shipped through
the lossy transport (port of ``repro/serve/serve_step.py``).

- ``make_prefill``: (params, tokens (B, S)) -> (last-position logits,
  caches).
- ``make_decode``: (params, caches, tokens (B, 1), index) -> (logits,
  caches): one new token written into the caches in place at ``index``.
- ``degrade_caches``: the prefill -> decode KV transfer under wire-row
  loss, coded (Hadamard, through the FWHT and unbias kernels on the
  card) or uncoded.

PyTorch runs eagerly, so the factories return plain closures where the
JAX package returns jitted functions.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import coding
from repro_torch.models import layers as L
from repro_torch.models import model as M


def make_prefill(cfg: ModelConfig, s_max: int):
    def prefill(params: M.Params, tokens: torch.Tensor):
        caches = M.init_caches(cfg, tokens.shape[0], s_max, tokens.device)
        logits = M.forward(params, cfg, tokens, caches=caches,
                           last_only=True)
        return logits[:, -1], caches
    return prefill


def make_decode(cfg: ModelConfig):
    def decode(params: M.Params, caches: L.AttnCache, tokens: torch.Tensor,
               index: int):
        """index: the position being generated.  Writes into ``caches``."""
        positions = torch.full((tokens.shape[0], 1), index,
                               device=tokens.device)
        logits = M.forward(params, cfg, tokens, caches=caches,
                           cache_index=index, positions=positions)
        return logits[:, -1], caches
    return decode


def greedy_decode(cfg: ModelConfig, params: M.Params, caches: L.AttnCache,
                  first_token: torch.Tensor, start_idx: int,
                  n_steps: int) -> torch.Tensor:
    """Greedy host-loop decode from an existing (possibly degraded) KV
    cache: ``first_token`` (B, 1) seeds the loop, ``start_idx`` is the
    cache position of the first generated token.  Returns (B, n_steps)
    tokens including ``first_token``.  Consumes ``caches``."""
    decode = make_decode(cfg)
    out = [first_token]
    idx = start_idx
    for _ in range(n_steps - 1):
        logits, caches = decode(params, caches, out[-1], idx)
        out.append(torch.argmax(logits, -1)[:, None])
        idx += 1
    return torch.cat(out, dim=1)


def greedy_generate(cfg: ModelConfig, params: M.Params, prompt: torch.Tensor,
                    n_steps: int, s_max: Optional[int] = None) -> torch.Tensor:
    """Small host-loop generator for examples/tests (greedy)."""
    s_max = s_max or (prompt.shape[1] + n_steps)
    logits, caches = make_prefill(cfg, s_max)(params, prompt)
    first = torch.argmax(logits, -1)[:, None]
    return greedy_decode(cfg, params, caches, first, prompt.shape[1], n_steps)


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


def degrade_caches(caches: L.AttnCache, mask: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   coded: bool = True,
                   signs: Optional[torch.Tensor] = None) -> L.AttnCache:
    """Apply one request's KV-transfer loss to its decode caches.

    The stacked K and the stacked V tensor are each flattened and shipped
    as one payload through :func:`kv_wire_roundtrip` under the same
    wire-row mask, and a new cache is returned; positions are metadata
    the transport does not code, and are copied.  The rotation signs are
    drawn once from ``generator`` and shared by both payloads (prefill
    and decode sides seed it alike, as the JAX key is shared); tests pass
    ``signs`` instead.
    """
    n_rot = int(mask.shape[0])
    mask = mask.to(caches.k.device)

    def _ship(leaf: torch.Tensor) -> torch.Tensor:
        code = coding.plan(leaf.numel(), n_rot=n_rot)
        if code.n_rot != n_rot:
            raise ValueError(
                f"KV leaf of {leaf.numel()} elements cannot carry a "
                f"{n_rot}-row wire mask (plan chose {code.n_rot})")
        out = kv_wire_roundtrip(leaf.reshape(-1).to(torch.float32), mask,
                                signs, code, coded=coded)
        return out.reshape(leaf.shape).to(leaf.dtype)

    if coded and signs is None:
        if generator is None:
            raise ValueError("coded degrade_caches needs a generator or signs")
        code = coding.plan(caches.k.numel(), n_rot=n_rot)
        signs = coding.rademacher(generator, code).to(caches.k.device)
    return L.AttnCache(k=_ship(caches.k), v=_ship(caches.v),
                       pos=caches.pos.clone())


def kv_position_error(clean: L.AttnCache, degraded: L.AttnCache,
                      n_ctx: int) -> torch.Tensor:
    """(n_ctx,) per-position relative KV error after lossy transfer.

    For each cache position ``s < n_ctx``, the relative L2 error of its
    K/V vectors summed over every layer.  An uncoded lost chunk drives
    whole positions to error ~1; the coded path spreads the same loss as
    small noise over all positions.  The share of positions under an
    error threshold is fig8's usable-context fraction.
    """
    dev = clean.k.device
    err2 = torch.zeros(n_ctx, device=dev)
    ref2 = torch.zeros(n_ctx, device=dev)
    for a0, a1 in ((clean.k, degraded.k), (clean.v, degraded.v)):
        # (L, B, S, KV, Dh): fold everything but the position axis
        d = torch.movedim((a1 - a0) ** 2, 2, 0)
        r = torch.movedim(a0.to(torch.float32) ** 2, 2, 0)
        err2 = err2 + d[:n_ctx].reshape(n_ctx, -1).sum(1)
        ref2 = ref2 + r[:n_ctx].reshape(n_ctx, -1).sum(1)
    return torch.sqrt(err2 / torch.clamp(ref2, min=1e-12))
