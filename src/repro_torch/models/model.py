"""Top-level causal LM (port of ``repro/models/model.py`` for
``block_pattern=("global",)``): forward, caches, and the training loss.

Parameters are a flat state dict of tensors with dotted names
(``embed.table``, ``layers.{i}.attn.wq``, ``final_norm.scale``, ...),
each weight in the JAX layout.  The caches are one stacked
:class:`~repro_torch.models.layers.AttnCache` for all layers, as the JAX
model stacks the caches of its scanned layers.

On a mesh with a ``model`` axis the parameters are this rank's shards
(``convert.shard_leaves``) and ``tp`` its
:class:`~repro_torch.sharding.ModelGroup` (``convert.model_group``,
which names the split leaves): the layers run tensor
parallel, the logits come out split over the vocabulary, and
:func:`lm_loss` is the JAX package's vocab-parallel cross-entropy.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = L.Params


def check_supported(cfg: ModelConfig) -> None:
    if (cfg.block_pattern != ("global",) or cfg.mlp_type != "swiglu"
            or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: only tied-embedding swiglu models with "
            "block_pattern=('global',) are ported yet")


def _trunc_normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Truncated normal in [-2, 2] std, std = 1/sqrt(fan_in), as in JAX."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * shape[0] ** -0.5).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random weights on the generator's device, drawn in a fixed order.

    The draws differ from ``jax.random``'s; tests carry the JAX weights
    across with :func:`repro_torch.models.convert.params_from_jax`.
    The TP padding heads are zero in wq and wo, so they are inert.
    """
    check_supported(cfg)
    dev = generator.device
    dt = L.dtype_of(cfg)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    h, hp, kv = cfg.n_heads, cfg.n_heads_padded, cfg.n_kv_heads

    def tn(*shape):
        return _trunc_normal(generator, shape, dt, dev)

    p: Params = {"embed.table": tn(cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        p[pre + "ln1.scale"] = torch.zeros(d, device=dev)
        p[pre + "attn.wq"] = wq = tn(d, hp * hd)
        p[pre + "attn.wk"] = tn(d, kv * hd)
        p[pre + "attn.wv"] = tn(d, kv * hd)
        p[pre + "attn.wo"] = wo = tn(hp * hd, d)
        wq[:, h * hd:] = 0
        wo[h * hd:, :] = 0
        if cfg.qkv_bias:
            p[pre + "attn.bq"] = torch.zeros(hp * hd, dtype=dt, device=dev)
            p[pre + "attn.bk"] = torch.zeros(kv * hd, dtype=dt, device=dev)
            p[pre + "attn.bv"] = torch.zeros(kv * hd, dtype=dt, device=dev)
        p[pre + "ln2.scale"] = torch.zeros(d, device=dev)
        p.update({pre + "mlp.wi": tn(d, f), pre + "mlp.wg": tn(d, f),
                  pre + "mlp.wo": tn(f, d)})
    p["final_norm.scale"] = torch.zeros(d, device=dev)
    return p


def sub_params(params: Params, prefix: str) -> Params:
    """The entries under ``prefix`` with the prefix removed."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            caches: Optional[L.AttnCache] = None,
            cache_index: Optional[int] = None,
            positions: Optional[torch.Tensor] = None,
            last_only: bool = False,
            tp: Optional[shd.ModelGroup] = None) -> torch.Tensor:
    """Logits (B, S or 1, V) in the compute dtype.

    With ``caches`` the K/V of every layer are written into them in place
    (prefill, or one decode token at ``cache_index``).  With ``tp``
    (``convert.model_group``) each block whose leaves the specs split
    runs tensor parallel, and V is this rank's share of the vocabulary
    when the table is split.
    """
    check_supported(cfg)
    eps = cfg.norm_eps
    table = params["embed.table"]
    vocab_tp = L.split_over_model("embed.table", tp)
    x = L.embed(table, cfg, tokens, vocab_tp)
    if positions is None:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
    for i in range(cfg.n_layers):
        p = sub_params(params, f"layers.{i}.")
        attn, mlp = sub_params(p, "attn."), sub_params(p, "mlp.")
        h = L.rmsnorm(p["ln1.scale"], x, eps)
        h = L.attention(attn, cfg, h, positions=positions,
                        cache=None if caches is None else caches.layer(i),
                        cache_index=cache_index,
                        tp=L.split_over_model("attn.wq", tp))
        x = x + h
        h = L.rmsnorm(p["ln2.scale"], x, eps)
        x = x + L.mlp(mlp, h, L.split_over_model("mlp.wi", tp))
    if last_only:   # prefill: only the last position's logits are used
        x = x[:, -1:]
    x = L.rmsnorm(params["final_norm.scale"], x, eps)
    return L.unembed(table, x, vocab_tp)


def lm_loss(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor],
            tp: Optional[shd.ModelGroup] = None):
    """Next-token cross-entropy.  Returns (loss, (nll, aux)) as JAX does;
    ``aux`` is the MoE auxiliary loss, 0 for the dense family.

    The cross-entropy is taken in float32 with the row max shifted out,
    as in JAX.  The label logit is gathered where JAX sums a one-hot
    product: the same value, since a sum with zeros is exact.  No remat:
    the port keeps the activations.

    With the logits split over the vocabulary (``tp``, a split table)
    every reduction over it is the local one, then one over ``model``, as
    the JAX package writes its CE so that GSPMD can (``model.py:327-
    335``): the row max a MAX all-reduce with no gradient (JAX's
    ``stop_gradient``), the sum of ``exp`` and the label logit (0 on the
    ranks that do not hold the label) ``reduce_from_model``.  No rank
    builds logits over the whole vocabulary.
    """
    logits = forward(params, cfg, batch["tokens"], tp=tp)
    labels = batch["labels"]
    n_txt = labels.shape[1]
    logits = logits[:, -n_txt:][:, :-1]
    tgt = labels[:, 1:].long()
    vocab_tp = L.split_over_model("embed.table", tp)
    mx = torch.amax(logits.detach(), dim=-1, keepdim=True).to(torch.float32)
    if vocab_tp is not None:
        shd.model_all_reduce(mx, vocab_tp, dist.ReduceOp.MAX)
    sum_exp = torch.sum(torch.exp(logits.to(torch.float32) - mx), dim=-1)
    if vocab_tp is None:
        label_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
    else:
        sum_exp = shd.reduce_from_model(sum_exp, vocab_tp)
        rows = logits.shape[-1]
        local = tgt - vocab_tp.index * rows
        mine = (local >= 0) & (local < rows)
        label_logit = torch.gather(logits, -1, torch.where(
            mine, local, 0)[..., None])[..., 0]
        label_logit = shd.reduce_from_model(
            torch.where(mine, label_logit, 0).to(torch.float32), vocab_tp)
    lse = torch.log(sum_exp) + mx[..., 0]
    nll = lse - label_logit.to(torch.float32)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return nll.mean() + aux, (nll.mean(), aux)


def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                device=None) -> L.AttnCache:
    dt = L.dtype_of(cfg)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return L.AttnCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        pos=torch.full((cfg.n_layers, s_max), -1, dtype=torch.int32,
                       device=device))
