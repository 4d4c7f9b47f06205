"""Model FLOPs and payload bytes from shapes alone, and the card's peaks.

Model FLOPs (what a ``*_mfu`` metric divides): 2 a multiply-add in the
forward pass and twice that in the backward; attention over the causal
half; an MoE layer over the ``top_k`` experts each token is routed to
and its router; no recomputation, no embedding lookup, no norms or
element-wise work.  Counted at the published widths of the ``model``
group of a configuration file (the published heads and experts, not the
port's padding).  A prefill's unembedding is the last position's alone,
as the port's ``last_only`` computes it.

Payload bytes (what an ``fwht_roofline`` metric divides): each rotated
payload's float32 elements, padded to whole rotation blocks, read once
and written once, for the encode and again for the decode.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

# NVIDIA H100 SXM, data sheet, dense: bf16 tensor core FLOP/s, HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def layer_matmul_flops_per_token(m: Dict) -> float:
    """Forward FLOPs of one layer's projections and MLP (or routed
    experts and router) for one token."""
    d, hd = m["d_model"], m["head_dim"]
    h, kv = m["n_heads"], m["n_kv_heads"]
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    moe = m.get("moe")
    if moe:
        mlp = d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_expert"]
    else:
        mlp = 3 * d * m["d_ff"]
    return 2.0 * (attn + mlp)


def attention_flops(m: Dict, seq: int) -> float:
    """Forward FLOPs of one layer's q.k and p.v for one causal sequence
    of ``seq`` tokens: 2 products x 2 x seq^2/2 x heads x head_dim."""
    return 2.0 * seq * seq * m["n_heads"] * m["head_dim"]


def forward_flops(m: Dict, seq: int, logits_rows: int) -> float:
    """One sequence's forward FLOPs, with the unembedding for
    ``logits_rows`` positions."""
    per_layer = seq * layer_matmul_flops_per_token(m) + attention_flops(m, seq)
    return (m["n_layers"] * per_layer
            + 2.0 * logits_rows * m["d_model"] * m["vocab_size"])


def train_step_flops(m: Dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: forward and backward (3x the
    forward) over ``batch`` sequences, the loss over every position."""
    return 3.0 * batch * forward_flops(m, seq, seq)


def prefill_flops(m: Dict, seq: int) -> float:
    """A batch-1 prefill's model FLOPs: the forward, the unembedding of
    the last position only."""
    return forward_flops(m, seq, 1)


def padded(numel: int, n_rot: int) -> int:
    return -(-numel // n_rot) * n_rot


def rotation_n(numel: int, n_rot: int) -> int:
    """The rotation width a payload of ``numel`` takes: ``n_rot`` halved
    while it exceeds the payload (the coding plans' rule)."""
    while n_rot > 1 and n_rot > numel:
        n_rot //= 2
    return max(n_rot, 2)


def fwht_bytes(numels: Iterable[int], n_rot: int) -> float:
    """FWHT bytes of coding then decoding each payload: float32, padded
    to whole rotation blocks, read once and written once, twice."""
    return float(sum(2 * 2 * 4 * padded(n, rotation_n(n, n_rot))
                     for n in numels))


def numel(shape: Sequence[int]) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out
