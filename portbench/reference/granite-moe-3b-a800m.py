"""Granite 3.0 MoE's layout and feed-forward block for the plain
reference: GQA without bias, full rotary, a tied embedding, and routed
SwiGLU experts (``moe.py``) in place of the MLP.  The leaves are those of
the port's leaf view; the experts are padded to a multiple of 16 as the
port holds them (the padded ones are never routed), and the heads to the
file's ``head_pad_multiple`` (padded heads' wq columns and wo rows 0 at
init; granite's 24 heads take none at 8)."""
from __future__ import annotations

from typing import Dict, List

from portbench.reference import dense, moe


def leaf_specs(m: Dict) -> List[Dict]:
    d, hd, kv = m["d_model"], m["head_dim"], m["n_kv_heads"]
    v = m["vocab_size"]
    n, e = m["n_layers"], moe.padded_experts(m["moe"])
    f = m["moe"]["d_expert"]
    hp = dense.head_pad(m)
    pre = dense.PREFIX

    def leaf(name, shape, std, dtype="bfloat16", **kw):
        return dict(name=pre + name, shape=shape, std=std, dtype=dtype, **kw)

    return [leaf("attn.wk", (n, d, kv * hd), d ** -0.5),
            leaf("attn.wo", (n, hp * hd, d), (hp * hd) ** -0.5,
                 zero=(1, m["n_heads"] * hd)),
            leaf("attn.wq", (n, d, hp * hd), d ** -0.5,
                 zero=(2, m["n_heads"] * hd)),
            leaf("attn.wv", (n, d, kv * hd), d ** -0.5),
            leaf("ln1.scale", (n, d), 0.0),
            leaf("ln2.scale", (n, d), 0.0),
            leaf("moe.router", (n, d, e), d ** -0.5, dtype="float32"),
            leaf("moe.wg", (n, e, d, f), d ** -0.5),
            leaf("moe.wi", (n, e, d, f), d ** -0.5),
            leaf("moe.wo", (n, e, f, d), f ** -0.5),
            dict(name="embed.table", shape=(v, d), std=v ** -0.5,
                 dtype="bfloat16"),
            dict(name="final_norm.scale", shape=(d,), std=0.0,
                 dtype="bfloat16")]


ffn = moe.ffn
