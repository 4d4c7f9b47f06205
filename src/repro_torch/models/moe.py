"""Mixture-of-Experts block with expert parallelism (port of
``repro/models/moe.py``).

- router: softmax top-k over the routed experts in float32 (padded
  experts at -1e30, never picked), the picks renormalised; the aux loss
  is the load balance plus the router z-loss.
- dispatch: capacity-based.  Each (token, pick) gets a slot in its
  expert's capacity buffer: its rank among the picks of its expert, in
  token-major, pick-minor order; picks beyond the capacity are dropped
  (their rows are zero).  Only the G * k picked rows move.
- the routed experts are one batched SwiGLU over (E, C, d) buffers; the
  shared experts (``n_shared``) a dense SwiGLU beside them.

Expert parallelism: the JAX package writes it in GSPMD form; the port
runs it with explicit collectives over the
:class:`~repro_torch.sharding.ModelGroup` whose ranks hold E / tp
experts each.  On a ``model`` axis of ``tp > 1`` with ``S % tp == 0``
and ``S >= tp``, model rank ``r`` takes its slice of the sequence
(``scatter_to_model``), routes and dispatches it into (E, cap, d), sends
each expert shard its block (``all_to_all_model``), runs its own
experts on the (E / tp, tp * cap, d) rows it received, sends the
results back, combines its tokens and gathers the slices into the
replicated (B, S, d) (``gather_replicated``).  The router, replicated,
gets the sum of the ranks' gradients (``copy_to_model``), and the aux is
the mean over senders.  Otherwise (decode, or ``S`` not divisible) the
block runs the local path on the whole experts, gathered over
``model``.  Celeris's lossy dispatch drops whole (sender, expert-shard)
blocks: sender ``r``'s block to shard ``j`` arrives when
``coins[r, j] >= drop_rate``; the expert sees zeros (swiglu(0) = 0) and
those tokens fall back to the shared experts and the residual (paper
§ II-B).

The experts are zero-padded to a multiple of 16 (60 -> 64, 40 -> 48,
8 -> 16) so that the shapes do not depend on the mesh.

JAX computes all of this outside any Pallas kernel (its expert FFN is
three einsums), so the port's is torch ops: the products are batched
matmuls.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = L.Params

EXPERT_PAD_MULTIPLE = 16   # fixed, so param shapes are mesh-independent

# When a list, every dispatch appends the count of picks its capacity
# dropped (a 0-dim tensor, no host sync); None (the default) records
# nothing.
drop_log: Optional[List[torch.Tensor]] = None


def padded_experts(cfg: ModelConfig, tp: int = EXPERT_PAD_MULTIPLE) -> int:
    e = cfg.moe.n_experts
    return -(-e // EXPERT_PAD_MULTIPLE) * EXPERT_PAD_MULTIPLE


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """One layer's MoE leaves, drawn in JAX's order (router, wi, wg, wo,
    then the shared experts' wi, wg, wo), each truncated normal with
    JAX's fan-in: d for the router, ``wi`` and ``wg``, the expert width
    for ``wo`` and the shared width for ``shared.wo``.  The router is
    drawn in the compute dtype, then kept in float32."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    e_pad = padded_experts(cfg)
    dt = L.dtype_of(cfg)

    def tn(shape, fan_in):
        return L.trunc_normal(generator, shape, dt, fan_in)

    p: Params = {
        "router": tn((d, e_pad), d).to(torch.float32),
        "wi": tn((e_pad, d, f), d),
        "wg": tn((e_pad, d, f), d),
        "wo": tn((e_pad, f, d), f),
    }
    if m.n_shared:
        fs = m.n_shared * m.d_expert
        p["shared.wi"] = tn((d, fs), d)
        p["shared.wg"] = tn((d, fs), d)
        p["shared.wo"] = tn((fs, d), fs)
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """Partition specs of one layer's MoE leaves: the experts split over
    ``model`` on E, the shared experts Megatron column/row, the router
    replicated (``train/sharding_rules.py`` holds the same rules for the
    stacked leaves)."""
    specs = {"router": (), "wi": (shd.MODEL_AXIS, None, None),
             "wg": (shd.MODEL_AXIS, None, None),
             "wo": (shd.MODEL_AXIS, None, None)}
    if cfg.moe and cfg.moe.n_shared:
        specs.update({"shared.wi": (None, shd.MODEL_AXIS),
                      "shared.wg": (None, shd.MODEL_AXIS),
                      "shared.wo": (shd.MODEL_AXIS, None)})
    return specs


def _capacity(cfg: ModelConfig, g_tokens: int, tp: int) -> int:
    m = cfg.moe
    c = int(g_tokens * m.top_k * m.capacity_factor) // padded_experts(cfg, tp)
    return max(8, -(-c // 8) * 8)   # rounded up to 8, as JAX's tiling


def _route(router: torch.Tensor, cfg: ModelConfig, x2d: torch.Tensor,
           e_pad: int):
    """Top-k routing.  x2d: (G, d) -> (probs (G, k), ids (G, k), aux)."""
    m = cfg.moe
    logits = x2d.to(torch.float32) @ router
    if e_pad > m.n_experts:   # the padded experts are unroutable
        pad = torch.arange(e_pad, device=x2d.device) >= m.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    ce = torch.zeros(e_pad, dtype=torch.float32, device=x2d.device)
    ce = ce.index_add(0, top_i.reshape(-1),
                      torch.ones(top_i.numel(), device=x2d.device)
                      ) / top_i.numel()
    aux = (m.aux_weight * e_pad * torch.sum(me * ce)
           + m.router_z_weight * torch.mean(
               torch.square(torch.logsumexp(logits, dim=-1))))
    return top_p, top_i, aux


def _dispatch_indices(top_i: torch.Tensor, e_pad: int, cap: int):
    """Slot assignment: (G, k) expert ids -> (flat ids, slots, keep).

    A pick's slot is the count of earlier picks (in flat order) of its
    expert: JAX's cumsum over the (G*k, E) one-hot, taken here as each
    pick's rank in a stable sort by expert, which on the card is far
    cheaper than a scan down G*k rows."""
    flat = top_i.reshape(-1)                                   # (G*k,)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e_pad)
    first = torch.cumsum(counts, 0) - counts      # each expert's first rank
    slot = torch.empty_like(flat)
    slot[order] = (torch.arange(flat.numel(), device=flat.device)
                   - first[flat[order]])
    keep = slot < cap
    if drop_log is not None:
        drop_log.append((~keep).sum())
    return flat, slot, keep


def _expert_ffn(wi, wg, wo, h: torch.Tensor) -> torch.Tensor:
    """h: (E_local, C_total, d) -> same; a SwiGLU per expert."""
    return torch.bmm(F.silu(torch.bmm(h, wg)) * torch.bmm(h, wi), wo)


def _scatter_combine(x2d, top_p, flat, slot, keep, out_buf, cap):
    """Gather the expert outputs back to token order, weighted by the
    router's renormalised probabilities; dropped picks count 0."""
    g, d = x2d.shape
    k = top_p.shape[-1]
    got = out_buf[flat, torch.clamp(slot, max=cap - 1)]
    got = got * (keep[:, None] * top_p.reshape(-1)[:, None]).to(got.dtype)
    return got.reshape(g, k, d).sum(1)


def _dispatch_2d(router, cfg, x2d, e_pad, cap, src_mask=None):
    """Route and dispatch a (G, d) token block into (E, C, d) capacity
    buffers.  ``src_mask`` (E,): the arrival mask of this sender's blocks
    (Celeris lossy dispatch: picks bound for a dropped (sender,
    expert-shard) block never arrive and combine to 0).  Returns (buf,
    combine, aux): ``combine(out_buf)`` gives the (G, d) output."""
    d = x2d.shape[-1]
    k = cfg.moe.top_k
    top_p, top_i, aux = _route(router, cfg, x2d, e_pad)
    flat, slot, keep = _dispatch_indices(top_i, e_pad, cap)
    if src_mask is not None:
        keep = keep & src_mask[flat]
    rows = (torch.repeat_interleave(x2d, k, dim=0)
            * keep[:, None].to(x2d.dtype))
    # JAX adds the dropped picks' zero rows into slot cap - 1; here they
    # go to a spare slot cap, cut off after, so that every kept pick owns
    # its (expert, slot) and the scatter needs no accumulation
    buf = x2d.new_zeros((e_pad, cap + 1, d)).index_put(
        (flat, torch.where(keep, slot, cap)), rows)[:, :cap]

    def combine(out_buf):
        return _scatter_combine(x2d, top_p, flat, slot, keep, out_buf, cap)

    return buf, combine, aux


def _moe_local(p, cfg, x2d, e_pad, cap, experts=None):
    """The one-device path (no EP collectives).  ``experts`` (wi, wg, wo)
    replace ``p``'s (the whole experts gathered over ``model``)."""
    wi, wg, wo = experts or (p["wi"], p["wg"], p["wo"])
    buf, combine, aux = _dispatch_2d(p["router"], cfg, x2d, e_pad, cap)
    return combine(_expert_ffn(wi, wg, wo, buf)), aux


def _moe_ep(p, cfg, x, e_pad, ep: shd.ModelGroup,
            src_mask: Optional[torch.Tensor]):
    """Expert parallelism over ``ep``: this rank's slice of the sequence
    dispatched to the ranks that own its experts and back.  ``src_mask``
    (E,): this sender's arrival mask, or None."""
    d = x.shape[-1]
    n = ep.size
    e_loc = e_pad // n
    x_r = shd.scatter_to_model(x, ep, 1)                   # (B, S/tp, d)
    cap = _capacity(cfg, x_r.shape[0] * x_r.shape[1], n)
    buf, combine, aux = _dispatch_2d(shd.copy_to_model(p["router"], ep),
                                     cfg, x_r.reshape(-1, d), e_pad, cap,
                                     src_mask)
    # the EP all-to-all: sender-major (tp, E/tp, C, d) -> each rank gets
    # its experts' blocks from every sender
    recv = shd.all_to_all_model(buf.reshape(n, e_loc, cap, d), ep)
    h = recv.transpose(0, 1).reshape(e_loc, n * cap, d)
    out = _expert_ffn(p["wi"], p["wg"], p["wo"], h)
    back = shd.all_to_all_model(
        out.reshape(e_loc, n, cap, d).transpose(0, 1).contiguous(), ep)
    y_r = combine(back.reshape(e_pad, cap, d)).reshape(x_r.shape)
    aux = shd.reduce_from_model(aux, ep) / n               # mean over senders
    return shd.gather_replicated(y_r, ep, 1), aux


def layer_coins(layer: int, tp: int) -> torch.Tensor:
    """Layer ``layer``'s (tp, tp) arrival uniforms, float32 on the CPU,
    from a fixed per-layer seed: the same every step, as the JAX
    reference's ``fold_in(PRNGKey(0), layer)`` draws are (its step key
    never reaches the MoE block).  torch cannot draw JAX's bits, so the
    tests hand JAX's uniforms in (``LossyCtx.coins``)."""
    return torch.rand((tp, tp), generator=torch.Generator().manual_seed(
        layer))


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              tp: Optional[shd.ModelGroup] = None,
              layer: int = 0,
              lossy: bool = False,
              coins: Optional[torch.Tensor] = None,
              drop_rate=0.0,
              rows: Optional[shd.RowGroup] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux).  Adds the shared experts' output.

    ``p``: one layer's MoE leaves (``router``, ``wi``, ``wg``, ``wo``,
    ``shared.*``), this rank's shards of those split over ``model``
    (``tp.split``); ``layer`` its index.  ``lossy``: the Celeris lossy
    dispatch on the EP path, with ``coins`` the layer's (tp, tp)
    uniforms (:func:`layer_coins` when None) against ``drop_rate``;
    inert elsewhere, as in JAX.  ``rows``: route the rows of every rank of
    this group together (:func:`repro_torch.sharding.gather_rows`), as
    the JAX step does over its global batch outside the lossy island;
    this rank keeps its own rows of the output."""
    e_pad = padded_experts(cfg)
    x_own = x
    if rows is not None:
        x = shd.gather_rows(x, rows)
    b, s, d = x.shape
    ep = L.split_over_model("moe.wi", tp)
    if tp is not None and ep is None:
        raise NotImplementedError(
            f"{cfg.name}: {e_pad} experts do not split over {tp.size} model "
            "ranks")
    if ep is None or s % ep.size or s < ep.size:
        # one device, or decode: local dispatch on the whole experts
        experts = (None if ep is None else
                   [shd.gather_replicated(p[n], ep, 0)
                    for n in ("wi", "wg", "wo")])
        routed, aux = _moe_local(p, cfg, x.reshape(-1, d), e_pad,
                                 _capacity(cfg, b * s, 1), experts)
        routed = routed.reshape(b, s, d)
    else:
        src_mask = None
        if lossy:
            u = coins if coins is not None else layer_coins(layer, ep.size)
            arrive = u.to(x.device) >= torch.as_tensor(
                drop_rate, dtype=torch.float32, device=x.device)
            src_mask = torch.repeat_interleave(arrive[ep.index],
                                               e_pad // ep.size)
        routed, aux = _moe_ep(p, cfg, x, e_pad, ep, src_mask)
    if rows is not None:
        routed = routed.narrow(0, rows.index * x_own.shape[0],
                               x_own.shape[0])

    if "shared.wi" in p:
        shared = {n: p[f"shared.{n}"] for n in ("wi", "wg", "wo")}
        routed = routed + L.mlp(shared, cfg, x_own,
                                L.split_over_model("moe.shared.wi", tp))
    return routed, aux
