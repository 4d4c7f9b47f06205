"""The plain reference: a decoder of the repo's model family in float32.

Plain ``torch`` operations only, on the inputs the benchmark made; it
imports nothing of the program (``repro_torch``) and takes nothing the
program made.  It computes what the port claims to compute, with the
model family's own conventions (RMSNorm as ``(1 + scale)``, the
embedding scaled by sqrt(d) rounded to bfloat16, interleaved rotary over
the first ``rope_fraction`` of a head, GQA over the padded heads, the
float32 cross-entropy), each listed as a departure in the configuration
file where it departs from the published model.

``low``: the control, float8 training as it is done: every product
that the configuration runs in bfloat16 (the projections, the MLP or
experts, the unembedding, and the attention's probabilities times
values) takes operands rounded to float8 e4m3 with one scale a tensor
(its absolute maximum over the format's largest), and the gradient of
each such operand is rounded to float8 e5m2 the same way.
The logits q.k stay float32, as the configuration states them.

A configuration's file beside this one (``<arch>.py``) gives its leaf
layout (:func:`leaf_specs` there) and its feed-forward block.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
PREFIX = "decoder.groups[0]."


def strict_float32() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rounded(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` on one scale (its absolute
    maximum over the format's largest), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(F32) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, its gradient rounded to e5m2."""
    return _Fp8.apply(x)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return rounded(x)

    @staticmethod
    def backward(ctx, grad):
        return rounded(grad, torch.float8_e5m2)


def mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    if low:
        a, b = fp8(a), fp8(b)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         fraction: float) -> torch.Tensor:
    """Rotate interleaved pairs (0, 1), (2, 3), ... of the first
    ``int(head_dim * fraction)`` (even) dims of x (B, S, H, hd) by
    position; the rest pass through."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    freq = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=F32,
                                        device=x.device) / rot)
    ang = pos.to(F32)[:, None] * freq[None, :]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    y = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([y.flatten(-2), x[..., rot:]], -1)


def head_pad(m: Dict) -> int:
    k = m["head_pad_multiple"]
    return -(-m["n_heads"] // k) * k


def _attend(q, k, v, q0: int, low: bool):
    """Causal attention of the query block starting at position ``q0``:
    q (B, bq, KV, rep, hd), k and v (B, S, KV, hd)."""
    b, bq, kvh, rep, hd = q.shape
    s = k.shape[1]
    logits = torch.einsum("bqkrd,bskd->bkrqs", q, k) * hd ** -0.5
    qpos = torch.arange(q0, q0 + bq, device=q.device)
    mask = torch.arange(s, device=q.device)[None, :] <= qpos[:, None]
    probs = torch.softmax(torch.where(mask, logits, -1e30), -1)
    if low:
        probs, v = fp8(probs), fp8(v)
    return torch.einsum("bkrqs,bskd->bqkrd", probs, v)


def attention(lp: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict,
              low: bool, block: int = 512, remat: bool = False):
    """Self-attention of the layer ``lp`` over x (B, S, D) from position
    0: (output (B, S, D), rotated k (B, S, KV, hd), v).  Queries go in
    blocks of ``block`` rows; ``remat`` recomputes each block in the
    backward."""
    b, s, _ = x.shape
    hd, kvh, hp = m["head_dim"], m["n_kv_heads"], head_pad(m)
    pos = torch.arange(s, device=x.device)

    def proj(w, bias, heads):
        y = mm(x, lp[w], low)
        if bias in lp:
            y = y + lp[bias]
        return y.reshape(b, s, heads, hd)

    q = rope(proj("attn.wq", "attn.bq", hp), pos, m["rope_theta"],
             m["rope_fraction"])
    k = rope(proj("attn.wk", "attn.bk", kvh), pos, m["rope_theta"],
             m["rope_fraction"])
    v = proj("attn.wv", "attn.bv", kvh)
    qg = q.reshape(b, s, kvh, hp // kvh, hd)
    outs = []
    for q0 in range(0, s, block):
        args = (qg[:, q0:q0 + block], k, v, q0, low)
        outs.append(checkpoint(_attend, *args, use_reentrant=False)
                    if remat else _attend(*args))
    o = torch.cat(outs, 1).reshape(b, s, hp * hd)
    return mm(o, lp["attn.wo"], low), k, v


def swiglu(x, wi, wg, wo, low: bool):
    return mm(F.silu(mm(x, wg, low)) * mm(x, wi, low), wo, low)


def embed_scale(d: int) -> float:
    """sqrt(d) rounded to bfloat16, the model family's embedding scale."""
    return float(torch.tensor(d ** 0.5, dtype=torch.bfloat16))


def layer(P: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's weights from the stacked leaves, by short name."""
    n = len(PREFIX)
    return {k[n:]: v[i] for k, v in P.items() if k.startswith(PREFIX)}


def block(lp, x, m: Dict, ffn: Callable, low: bool, remat: bool = False):
    """One pre-norm layer: (x, its aux loss, k, v)."""
    eps = m["norm_eps"]
    a, k, v = attention(lp, rmsnorm(x, lp["ln1.scale"], eps), m, low,
                        remat=remat)
    x = x + a
    f, aux = ffn(lp, rmsnorm(x, lp["ln2.scale"], eps), m, low)
    return x + f, aux, k, v


def unembed_weight(P: Dict[str, torch.Tensor], m: Dict) -> torch.Tensor:
    return P["embed.table"].T if m["tie_embeddings"] else P["embed.unembed"]


def hidden(P, tokens, m: Dict, ffn: Callable, low: bool, remat: bool,
           kv: Optional[List] = None):
    """The residual stream after the last layer and the summed aux loss;
    ``kv`` collects each layer's (k, v)."""
    x = P["embed.table"][tokens] * embed_scale(m["d_model"])
    aux = torch.zeros((), dtype=F32, device=x.device)

    def one(i, x):
        y, a, k, v = block(layer(P, i), x, m, ffn, low, remat=remat)
        return y, a, k, v

    for i in range(m["n_layers"]):
        if remat:
            x, a, _, _ = checkpoint(one, i, x, use_reentrant=False)
        else:
            x, a, k, v = one(i, x)
            if kv is not None:
                kv.append((k, v))
        aux = aux + a
    return x, aux


def _nll_sum(x, w, labels, final, eps, low):
    logits = mm(rmsnorm(x, final, eps), w, low)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def lm_loss(P, batch, m: Dict, ffn: Callable, low: bool,
            rows: int = 4096) -> torch.Tensor:
    """Next-token cross-entropy (mean over B x (S - 1)) plus the aux
    loss; layers and cross-entropy chunks recomputed in the backward."""
    x, aux = hidden(P, batch["tokens"], m, ffn, low, remat=True)
    d = x.shape[-1]
    x = x[:, :-1].reshape(-1, d)
    labels = batch["labels"][:, 1:].reshape(-1)
    w = unembed_weight(P, m)
    total = 0.0
    for r in range(0, x.shape[0], rows):
        total = total + checkpoint(
            _nll_sum, x[r:r + rows], w, labels[r:r + rows],
            P["final_norm.scale"], m["norm_eps"], low, use_reentrant=False)
    return total / x.shape[0] + aux


def prefill(P, tokens, m: Dict, ffn: Callable, low: bool):
    """(last position's logits (V,), [(k, v)] a layer) of one prompt
    (1, S)."""
    kv: List = []
    with torch.no_grad():
        x, _ = hidden(P, tokens, m, ffn, low, remat=False, kv=kv)
        x = rmsnorm(x[:, -1], P["final_norm.scale"], m["norm_eps"])
        logits = mm(x, unembed_weight(P, m), low)[0]
    return logits, kv


# ---------------------------------------------------------------------
# The coded wire (Hadamard coding, loss of whole wire rows, unbiased
# decode) and AdamW, in float32
# ---------------------------------------------------------------------

def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform (Sylvester, natural order)
    along the last axis."""
    n = x.shape[-1]
    y, h = x.reshape(-1, n), 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        y = torch.stack((y[:, :, 0] + y[:, :, 1], y[:, :, 0] - y[:, :, 1]),
                        2)
        h *= 2
    return y.reshape(x.shape)


def rotation_n(numel: int, n_rot: int) -> int:
    while n_rot > 1 and n_rot > numel:
        n_rot //= 2
    return max(n_rot, 2)


def ship(x: torch.Tensor, mask: torch.Tensor, signs: torch.Tensor
         ) -> torch.Tensor:
    """One payload through the coded wire: flattened, cut into blocks of
    n = len(mask) (zero-padded), each block times the signs and rotated
    (H / sqrt(n)); wire row j (coordinate j of every block) arrives
    where ``mask[j]``; the arrived rows scaled by n / (rows arrived),
    rotated back, times the signs."""
    n = mask.shape[0]
    flat = x.reshape(-1).to(F32)
    blocks = F.pad(flat, (0, -flat.numel() % n)).reshape(-1, n)
    rot = fwht(blocks * signs) * n ** -0.5
    arrived = mask.to(F32)
    k = arrived.sum()
    rot = rot * arrived * torch.where(k > 0, n / k.clamp(min=1), 0.0)
    out = fwht(rot) * n ** -0.5 * signs
    return out.reshape(-1)[:flat.numel()].reshape(x.shape)


def schedule(k: int, o: Dict) -> float:
    """AdamW's learning rate at step k (1-based): linear warm-up, then
    cosine decay to ``min_lr_frac``."""
    if k < o["warmup_steps"]:
        return o["lr"] * k / max(o["warmup_steps"], 1)
    prog = min(max((k - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * (o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def train(P: Dict[str, torch.Tensor], names: Sequence[str], batches,
          draws, m: Dict, ffn: Callable, o: Dict, low: bool,
          W0: Optional[Sequence[torch.Tensor]] = None):
    """``len(batches)`` steps of the coded sync and AdamW from the
    weights ``P`` (float32, updated in place): each step's loss, the
    first gradient as AdamW takes it (coded, then clipped) a leaf, and
    each leaf's change after the last step, as norms.  ``draws[k]``:
    (masks, signs) by leaf index for step k's coded leaves; ``W0``: the
    starting weights in any dtype that holds them exactly (a copy of
    ``P``'s by default)."""
    W = [P[n] for n in names]
    if W0 is None:
        W0 = [w.detach().clone() for w in W]
    mu = [torch.zeros_like(w) for w in W]
    nu = [torch.zeros_like(w) for w in W]
    losses, first = [], None
    for k, (batch, (masks, signs)) in enumerate(zip(batches, draws), 1):
        for w in W:
            w.requires_grad_(True)
        loss = lm_loss(P, batch, m, ffn, low)
        grads = torch.autograd.grad(loss, W)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for w in W:
                w.requires_grad_(False)
            grads = [ship(g, masks[i], signs[i]) if i in masks else g
                     for i, g in enumerate(grads)]
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = min(1.0, o["clip_norm"] / max(float(gnorm), 1e-9))
            lr = schedule(k, o)
            bc1, bc2 = 1 - o["b1"] ** k, 1 - o["b2"] ** k
            if first is None:
                first = [float(g.norm()) * scale for g in grads]
            for g, w, a, b in zip(grads, W, mu, nu):
                g = g * scale
                a.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                b.mul_(o["b2"]).add_(g.square(), alpha=1 - o["b2"])
                step = (a / bc1) / ((b / bc2).sqrt() + o["eps"])
                w.sub_((step + w * o["weight_decay"]) * lr)
            del grads
    change = [float((w - w0.to(F32)).norm()) for w, w0 in zip(W, W0)]
    return {"losses": losses, "first_grad": first, "change": change}
