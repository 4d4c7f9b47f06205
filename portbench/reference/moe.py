"""The routed experts of the repo's MoE layer, plainly: a float32 router
over the experts padded to ``pad_multiple`` (the padded ones
unroutable), top-k with the picks renormalised, capacity per expert
``max(8, ceil8(int(G k capacity_factor) // padded))``, a pick kept when
fewer earlier picks (token-major, pick-minor) went to its expert than
that, each kept pick's SwiGLU weighted by its probability, and the aux
loss: load balance (``aux_weight`` x padded x sum(mean prob x share of
picks)) plus the router z-loss (``router_z_weight`` x mean logsumexp^2).
Expert by expert, with no capacity buffers."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import dense


def padded_experts(moe: Dict) -> int:
    k = moe["pad_multiple"]
    return -(-moe["n_experts"] // k) * k


def ffn(lp: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict, low: bool):
    moe = m["moe"]
    b, s, d = x.shape
    g, k = b * s, moe["top_k"]
    e_pad = padded_experts(moe)
    x2 = x.reshape(g, d)
    logits = x2 @ lp["moe.router"]
    logits = torch.where(
        torch.arange(e_pad, device=x.device) >= moe["n_experts"], -1e30,
        logits)
    probs = torch.softmax(logits, -1)
    top_p, top_i = torch.topk(probs, k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    share = torch.bincount(top_i.reshape(-1), minlength=e_pad).to(
        x.dtype) / (g * k)
    aux = (moe["aux_weight"] * e_pad * (probs.mean(0) * share).sum()
           + moe["router_z_weight"]
           * torch.logsumexp(logits, -1).square().mean())
    cap = int(g * k * moe["capacity_factor"]) // e_pad
    cap = max(8, -(-cap // 8) * 8)
    flat = top_i.reshape(-1)
    onehot = F.one_hot(flat, e_pad)
    rank = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    keep = rank < cap
    weight = top_p.reshape(-1)
    y = torch.zeros_like(x2)
    for e in range(moe["n_experts"]):
        picks = torch.nonzero((flat == e) & keep)[:, 0]
        if picks.numel() == 0:
            continue
        tok = picks // k
        out = dense.swiglu(x2[tok], lp["moe.wi"][e], lp["moe.wg"][e],
                           lp["moe.wo"][e], low)
        y = y.index_add(0, tok, out * weight[picks, None])
    return y.reshape(b, s, d), aux
