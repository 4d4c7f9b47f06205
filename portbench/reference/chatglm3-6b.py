"""ChatGLM3-6B's layout and feed-forward block for the plain reference:
GQA with QKV bias, partial rotary, an untied unembedding, SwiGLU of
``d_ff``.  The leaves are those of the port's leaf view (layers stacked
on a leading axis, in the JAX tree's order), initialised as the repo
initialises them: std fan_in**-0.5 along each per-layer matrix's first
axis, norm scales and biases 0, padded heads' wq columns and wo rows 0."""
from __future__ import annotations

from typing import Dict, List

from portbench.reference import dense


def leaf_specs(m: Dict) -> List[Dict]:
    d, hd, kv, f, v = (m["d_model"], m["head_dim"], m["n_kv_heads"],
                       m["d_ff"], m["vocab_size"])
    n = m["n_layers"]
    hp = dense.head_pad(m)
    pre = dense.PREFIX
    bf = "bfloat16"

    def leaf(name, shape, std, dtype=bf, **kw):
        return dict(name=name, shape=shape, std=std, dtype=dtype, **kw)

    out = []
    if m["qkv_bias"]:
        out += [leaf(pre + "attn.bk", (n, kv * hd), 0.0),
                leaf(pre + "attn.bq", (n, hp * hd), 0.0),
                leaf(pre + "attn.bv", (n, kv * hd), 0.0)]
    out += [leaf(pre + "attn.wk", (n, d, kv * hd), d ** -0.5),
            leaf(pre + "attn.wo", (n, hp * hd, d), (hp * hd) ** -0.5,
                 zero=(1, m["n_heads"] * hd)),
            leaf(pre + "attn.wq", (n, d, hp * hd), d ** -0.5,
                 zero=(2, m["n_heads"] * hd)),
            leaf(pre + "attn.wv", (n, d, kv * hd), d ** -0.5),
            leaf(pre + "ln1.scale", (n, d), 0.0),
            leaf(pre + "ln2.scale", (n, d), 0.0)]
    out += ffn_specs(m)
    out.append(leaf("embed.table", (v, d), v ** -0.5))
    if not m["tie_embeddings"]:
        out.append(leaf("embed.unembed", (d, v), d ** -0.5))
    out.append(leaf("final_norm.scale", (d,), 0.0))
    return out


def ffn_specs(m: Dict) -> List[Dict]:
    d, f, n = m["d_model"], m["d_ff"], m["n_layers"]
    pre = dense.PREFIX
    return [dict(name=pre + "mlp.wg", shape=(n, d, f), std=d ** -0.5,
                 dtype="bfloat16"),
            dict(name=pre + "mlp.wi", shape=(n, d, f), std=d ** -0.5,
                 dtype="bfloat16"),
            dict(name=pre + "mlp.wo", shape=(n, f, d), std=f ** -0.5,
                 dtype="bfloat16")]


def ffn(lp, x, m: Dict, low: bool):
    return (dense.swiglu(x, lp["mlp.wi"], lp["mlp.wg"], lp["mlp.wo"], low),
            x.new_zeros(()))
