"""Top-level model (port of ``repro/models/model.py`` for every family:
the dense ones, ``block_pattern`` of ``"global"`` and ``"local"``
layers, the MoE family, ``"moe"`` layers, the recurrent families,
``"rglru"`` (recurrentgemma) and ``"mlstm"``/``"slstm"`` (xLSTM) layers,
and the modality stubs, phi-3-vision's image frontend and seamless's
encoder-decoder): forward, caches, and the training loss.

Parameters are a flat state dict of tensors with dotted names
(``embed.table``, ``embed.unembed`` when untied, ``layers.{i}.attn.wq``,
``layers.{i}.pn1.scale`` with post-norms, ``layers.{i}.moe.wi`` in an
MoE layer, ``final_norm.scale``, ...), each weight in the JAX layout.
Layer ``i`` is of kind ``block_pattern[i % len(block_pattern)]``; an
MoE layer runs global attention, then :func:`repro_torch.models.moe.
moe_block` where a dense layer runs its MLP, and its aux loss adds up
over the layers.  An rglru layer (``layers.{i}.rglru.*``) runs the RG-LRU
block where attention would be, then its MLP, with no post-norms; an
mlstm or slstm layer (``layers.{i}.mlstm.*``, ``.slstm.*``) is a pre-norm
and its block, with no MLP.  The caches (:class:`Caches`) mirror the JAX
model's cache tree: one stacked node per position of the pattern (an
:class:`~repro_torch.models.layers.AttnCache`, or the layer kind's
recurrent state), then one per tail layer.

The modality stubs (JAX ``model.py:245-316``): a ``frontend_proj``
(frontend_dim, d) maps precomputed embeddings into the model width.
phi-3-vision's image embeddings, projected, are prepended to the
sqrt(d)-scaled text embeddings.  seamless's frames, projected (no
sqrt(d) scale), run through the encoder stack (``encoder.layers.{i}.*``,
bidirectional: rotary, no causal mask) and ``enc_norm`` (:func:`encode`)
into ``memory``; each decoder layer then runs cross-attention
(``layers.{i}.lnx.scale``, ``layers.{i}.xattn.*``) on it between its
self-attention and its MLP, only when ``memory`` is given.  The caches
hold the decoder's self-attention only: the cross K/V are computed from
``memory`` at every step, as in JAX.

On a mesh with a ``model`` axis the parameters are this rank's shards
(``convert.shard_leaves``) and ``tp`` its
:class:`~repro_torch.sharding.ModelGroup` (``convert.model_group``,
which names the split leaves): the layers run tensor parallel (the MoE
layers expert parallel; the recurrent blocks by channel or head, the
sLSTM's time loop on every rank; a stub's projected frontend gathered
over ``model``, its encoder stack and cross-attention on the attention's
TP layers), the logits come out split over the vocabulary where the
divisibility guard splits it, and :func:`lm_loss` is the JAX package's
vocab-parallel cross-entropy.

The JAX model never passes its ``base_key`` to ``_apply_stack``
(``model.py:307-310``), so an MoE layer's lossy-dispatch key is
``fold_in(PRNGKey(0), layer)`` whatever the step: the arrival uniforms
are fixed per layer for the whole run, and only the drop rate changes.
The port keeps that (:func:`repro_torch.models.moe.layer_coins`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.train import sharding_rules as rules

Params = L.Params


ATTN_KINDS = ("global", "local", "moe")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class LossyCtx:
    """Celeris context threaded into the MoE layers (JAX's ``LossyCtx``):
    the lossy expert dispatch on or off, its drop rate, and optionally
    each layer's (tp, tp) arrival uniforms (``coins[i]`` for layer i;
    None draws :func:`repro_torch.models.moe.layer_coins`).  JAX's
    ``key`` has no counterpart: it never reaches the MoE block."""
    enabled: bool = False
    drop_rate: float = 0.0
    coins: Optional[Sequence[torch.Tensor]] = None


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a block kind no model has (``ValueError``, as JAX's
    ``init_block`` raises on any other kind, an ``"xattn"`` block kind
    included: cross-attention is part of an enc-dec decoder block).
    Every family runs tensor parallel: the dense and MoE ones in every
    attention and MLP variant (with or without QKV bias, partial rotary,
    softcaps, post-norms (replicated), local windows, SwiGLU, GeGLU or
    squared ReLU, tied or untied embeddings), the recurrent blocks
    (:func:`repro_torch.models.rglru.rglru_block`,
    :func:`repro_torch.models.xlstm.mlstm_block` and ``slstm_block``),
    and the modality stubs' frontend projection, encoder stack and
    cross-attention."""
    kinds = sorted(set(cfg.block_pattern) - set(ATTN_KINDS + RECURRENT_KINDS))
    if kinds:
        raise ValueError(f"{cfg.name}: no block of kind {kinds}")


def logits_leaf(cfg: ModelConfig) -> str:
    """The leaf whose product gives the logits: ``embed.table`` when the
    embeddings are tied, ``embed.unembed`` when not.  Its split over
    ``model`` is the logits' split over the vocabulary."""
    return "embed.table" if cfg.tie_embeddings else "embed.unembed"


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random weights on the generator's device, drawn in a fixed order.

    The draws differ from ``jax.random``'s; tests carry the JAX weights
    across with :func:`repro_torch.models.convert.params_from_jax`.
    The TP padding heads are zero in wq and wo, so they are inert.  An
    enc-dec config also gets the encoder stack, ``enc_norm`` and each
    decoder layer's cross-attention; a frontend its ``frontend_proj``
    (fan-in ``frontend_dim``, as JAX's ``frontend_dim ** -0.5``).
    """
    check_supported(cfg)
    d = cfg.d_model
    zeros = functools.partial(torch.zeros, d, device=generator.device)
    p: Params = {"embed.table": _tn(generator, cfg, cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        p["embed.unembed"] = _tn(generator, cfg, d, cfg.vocab_size)
    plen = len(cfg.block_pattern)
    for i in range(cfg.n_layers):
        p.update(_init_block(cfg, cfg.block_pattern[i % plen], generator,
                             f"layers.{i}.", cross=cfg.is_encdec))
    p["final_norm.scale"] = zeros()
    for i in range(cfg.encoder_layers):
        p.update(_init_block(cfg, cfg.block_pattern[i % plen], generator,
                             f"encoder.layers.{i}."))
    if cfg.is_encdec:
        p["enc_norm.scale"] = zeros()
    if cfg.frontend:
        p["frontend_proj"] = _tn(generator, cfg, cfg.frontend_dim, d)
    return p


def _tn(generator: torch.Generator, cfg: ModelConfig, *shape
        ) -> torch.Tensor:
    """A weight of ``shape`` in the compute dtype, fan-in its first
    dim."""
    return L.trunc_normal(generator, shape, L.dtype_of(cfg), shape[0])


def _init_block(cfg: ModelConfig, kind: str, generator: torch.Generator,
                pre: str, cross: bool = False) -> Params:
    """One block's weights, named under ``pre`` (JAX ``init_block``);
    ``cross`` adds the cross-attention (``xattn.*``, ``lnx.scale``) to
    an attention block."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hp, kv = cfg.n_heads, cfg.n_heads_padded, cfg.n_kv_heads
    dev, dt = generator.device, L.dtype_of(cfg)
    zeros = functools.partial(torch.zeros, d, device=dev)
    p: Params = {}

    def sub(prefix: str, part: Params) -> None:
        p.update({pre + prefix + k: v for k, v in part.items()})

    def attn(prefix: str) -> None:
        a = {"wq": _tn(generator, cfg, d, hp * hd),
             "wk": _tn(generator, cfg, d, kv * hd),
             "wv": _tn(generator, cfg, d, kv * hd),
             "wo": _tn(generator, cfg, hp * hd, d)}
        a["wq"][:, h * hd:] = 0
        a["wo"][h * hd:, :] = 0
        if cfg.qkv_bias:
            for n, w in (("bq", hp * hd), ("bk", kv * hd), ("bv", kv * hd)):
                a[n] = torch.zeros(w, dtype=dt, device=dev)
        sub(prefix, a)

    p[pre + "ln1.scale"] = zeros()
    if kind in RECURRENT_KINDS:
        init = {"rglru": RG.init_rglru, "mlstm": XL.init_mlstm,
                "slstm": XL.init_slstm}[kind]
        sub(kind + ".", init(generator, cfg))
        if kind == "rglru":
            p[pre + "ln2.scale"] = zeros()
            sub("mlp.", _init_mlp(cfg, generator))
        return p
    attn("attn.")
    p[pre + "ln2.scale"] = zeros()
    if kind == "moe":
        sub("moe.", MOE.init_moe(generator, cfg))
    else:
        sub("mlp.", _init_mlp(cfg, generator))
    if cfg.post_norm:
        p[pre + "pn1.scale"] = zeros()
        p[pre + "pn2.scale"] = zeros()
    if cross:
        attn("xattn.")
        p[pre + "lnx.scale"] = zeros()
    return p


def _init_mlp(cfg: ModelConfig, generator: torch.Generator) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": _tn(generator, cfg, d, f)}
    if cfg.mlp_type != "sqrelu":
        p["wg"] = _tn(generator, cfg, d, f)
    p["wo"] = _tn(generator, cfg, f, d)
    return p


def sub_params(params: Params, prefix: str) -> Params:
    """The entries under ``prefix`` with the prefix removed."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
           caches: Optional["Caches"] = None,
           cache_index: Optional[int] = None,
           positions: Optional[torch.Tensor] = None,
           tp: Optional[shd.ModelGroup] = None,
           rows: Optional[shd.RowGroup] = None,
           image_embeds: Optional[torch.Tensor] = None,
           frame_embeds: Optional[torch.Tensor] = None,
           memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The residual stream (B, S, D) after the last block, before the
    final norm: :func:`hidden_aux` without the aux loss."""
    return hidden_aux(params, cfg, tokens, caches=caches,
                      cache_index=cache_index, positions=positions,
                      tp=tp, rows=rows, image_embeds=image_embeds,
                      frame_embeds=frame_embeds, memory=memory)[0]


def hidden_aux(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
               caches: Optional["Caches"] = None,
               cache_index: Optional[int] = None,
               positions: Optional[torch.Tensor] = None,
               tp: Optional[shd.ModelGroup] = None,
               lossy: Optional[LossyCtx] = None,
               rows: Optional[shd.RowGroup] = None,
               image_embeds: Optional[torch.Tensor] = None,
               frame_embeds: Optional[torch.Tensor] = None,
               memory: Optional[torch.Tensor] = None,
               remat: bool = False):
    """(the residual stream (B, S, D) after the last block, before the
    final norm; the MoE aux loss summed over the layers, float32, 0
    without MoE layers).  With ``caches`` the K/V of every attention
    layer and the state of every recurrent one are written into them in
    place (prefill, or one decode token at ``cache_index``).  Each
    attention block: pre-norm, attention of the layer's kind (``pn1`` on
    its output with ``post_norm``), residual; with ``memory`` and a
    cross-attention, pre-norm (``lnx``), cross-attention, residual;
    pre-norm, MLP or MoE (``pn2``), residual.  An rglru block: pre-norm,
    RG-LRU, residual; pre-norm, MLP, residual.  An mlstm or slstm block:
    pre-norm, the block, residual.  ``lossy``: the lossy expert
    dispatch of the MoE layers; ``rows``: the dp ranks whose rows the MoE
    layers route together (``moe.moe_block``).

    The frontend inputs, as JAX's ``forward`` takes them:
    ``image_embeds`` (B, n_frontend_tokens, frontend_dim) of a vision
    stub, projected and prepended to the text, so S counts them;
    ``frame_embeds`` (B, S_enc, frontend_dim) of an enc-dec config,
    encoded (:func:`encode`) into ``memory`` unless ``memory`` is
    given.  ``positions`` default to 0 .. S - 1.  ``remat``: the decoder
    stack recomputes its units in the backward, its residual stream split
    over ``model`` between them (:func:`_stack`); the training loss takes
    it, serving does not (JAX's ``serve_step.py:39,54``)."""
    check_supported(cfg)
    vocab_tp = L.split_over_model("embed.table", tp)
    x = L.embed(params["embed.table"], cfg, tokens, vocab_tp)
    if cfg.frontend == "vision_stub" and image_embeds is not None:
        x = torch.cat([_frontend(params, image_embeds, x.dtype, tp), x],
                      dim=1)
    if cfg.is_encdec and memory is None and frame_embeds is not None:
        memory = encode(params, cfg, frame_embeds, tp)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _stack(params, cfg, "layers.", cfg.n_layers, x,
                  positions=positions, caches=caches,
                  cache_index=cache_index, memory=memory, tp=tp,
                  lossy=lossy, rows=rows, remat=remat)


def _frontend(params: Params, embeds: torch.Tensor, dtype: torch.dtype,
              tp: Optional[shd.ModelGroup]) -> torch.Tensor:
    """Frontend embeddings cast to ``dtype`` @ ``frontend_proj``; with
    ``tp`` splitting it, the rank's columns of d gathered over ``model``
    (every rank then uses the whole rows alike, so the gather's backward
    keeps the rank's slice)."""
    x = embeds.to(dtype) @ params["frontend_proj"]
    tp = L.split_over_model("frontend_proj", tp)
    return x if tp is None else shd.gather_replicated(x, tp, -1)


def encode(params: Params, cfg: ModelConfig, frame_embeds: torch.Tensor,
           tp: Optional[shd.ModelGroup] = None) -> torch.Tensor:
    """The enc-dec encoder (JAX ``_encode``): frame embeddings (B,
    S_enc, frontend_dim) cast to the compute dtype @ ``frontend_proj``
    (no sqrt(d) scale), the encoder stack at positions 0 .. S_enc - 1
    with ``causal=False``, then ``enc_norm``: ``memory`` (B, S_enc, D).
    With ``tp`` the projection and the stack run tensor parallel
    (:func:`_frontend`, :func:`_stack`); ``memory`` is whole.  The stack
    takes remat, as JAX's ``_encode`` keeps ``_apply_stack``'s default
    even when serving: with ``tp`` its stream is split over ``model``
    between units there too (the checkpoint itself only runs where a
    gradient is taken)."""
    x = _frontend(params, frame_embeds, L.dtype_of(cfg), tp)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _stack(params, cfg, "encoder.layers.", cfg.encoder_layers, x,
                  positions=pos, causal=False, tp=tp, remat=True)
    return L.rmsnorm(params["enc_norm.scale"], x, cfg.norm_eps)


def _stack(params: Params, cfg: ModelConfig, prefix: str, n_layers: int,
           x: torch.Tensor, *, positions: torch.Tensor,
           caches: Optional["Caches"] = None,
           cache_index: Optional[int] = None,
           memory: Optional[torch.Tensor] = None, causal: bool = True,
           tp: Optional[shd.ModelGroup] = None,
           lossy: Optional[LossyCtx] = None,
           rows: Optional[shd.RowGroup] = None, remat: bool = False):
    """The blocks ``{prefix}{i}.*``, i < ``n_layers`` (JAX
    ``_apply_stack``): (x, the MoE aux loss).

    Layers ``[g * plen, (g + 1) * plen)``, g < ``n_layers // plen``
    (plen = ``len(block_pattern)``), form unit g, and each tail layer a
    unit of its own; a unit's aux loss is summed from zero, then added to
    the total, as JAX's scan carries it.  With ``remat`` (training) and
    no ``caches``, each unit runs under ``torch.utils.checkpoint``
    (non-reentrant; JAX's ``jax.checkpoint``): the backward recomputes
    it from its input, so only one unit's activations are alive there.
    The recompute repeats the forward exactly: the MoE arrival uniforms
    are fixed arrays, and the checkpoint keeps the RNG state.

    Sequence parallelism, JAX's pin of the residual stream over
    ``model`` (``model.py:176-208``), under JAX's gate: ``remat``, a
    model group ``tp``, S > 1 and S % tp == 0.  Between the pattern
    units the stream is this rank's block of the sequence, (B, S / tp,
    D) (:func:`repro_torch.sharding.split_sequence`), so a checkpoint
    keeps a 1/tp block; a unit gathers the blocks first
    (:func:`~repro_torch.sharding.gather_sequence`) and runs whole
    inside, and the tail runs on the whole sequence, as JAX pins only
    the pattern units.  Only copies are added: the result is the
    unpinned one bit for bit."""
    plen = len(cfg.block_pattern)
    n_groups = n_layers // plen
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = remat and caches is None and torch.is_grad_enabled()
    pin = (remat and tp is not None and n_groups > 0 and x.shape[1] > 1
           and x.shape[1] % tp.size == 0)

    def layers(x, lo, hi):
        a = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(lo, hi):
            x, ai = _block(params, cfg, prefix, i, x, positions=positions,
                           caches=caches, cache_index=cache_index,
                           memory=memory, causal=causal, tp=tp,
                           lossy=lossy, rows=rows)
            if ai is not None:
                a = a + ai
        return x, a

    def unit(x, lo, hi):
        if pin:
            x = shd.gather_sequence(x, tp)
        x, a = layers(x, lo, hi)
        return (shd.split_sequence(x, tp) if pin else x), a

    def run(fn, x, lo, hi):
        if ckpt:
            return checkpoint(fn, x, lo, hi, use_reentrant=False)
        return fn(x, lo, hi)

    if pin:
        x = shd.split_sequence(x, tp)
    for g in range(n_groups):
        x, a = run(unit, x, g * plen, (g + 1) * plen)
        aux = aux + a
    if pin:
        x = shd.gather_sequence(x, tp)
    for i in range(n_groups * plen, n_layers):
        x, a = run(layers, x, i, i + 1)
        aux = aux + a
    return x, aux


def _block(params: Params, cfg: ModelConfig, prefix: str, i: int,
           x: torch.Tensor, *, positions: torch.Tensor,
           caches: Optional["Caches"], cache_index: Optional[int],
           memory: Optional[torch.Tensor], causal: bool,
           tp: Optional[shd.ModelGroup], lossy: Optional[LossyCtx],
           rows: Optional[shd.RowGroup]):
    """Layer ``i`` of the stack ``prefix``: (x, its MoE aux loss, None
    in a layer without one)."""
    eps = cfg.norm_eps
    p = sub_params(params, f"{prefix}{i}.")
    kind = cfg.block_pattern[i % len(cfg.block_pattern)]
    h = L.rmsnorm(p["ln1.scale"], x, eps)
    if kind in RECURRENT_KINDS:
        block = {"rglru": RG.rglru_block, "mlstm": XL.mlstm_block,
                 "slstm": XL.slstm_block}[kind]
        cache = None if caches is None else caches.layer(i)
        h, new = block(sub_params(p, kind + "."), cfg, h, cache=cache,
                       tp=tp)
        if cache is not None:
            cache.store(new)
        x = x + h
        if kind == "rglru":
            h = L.rmsnorm(p["ln2.scale"], x, eps)
            x = x + L.mlp(sub_params(p, "mlp."), cfg, h,
                          L.split_over_model("mlp.wi", tp))
        return x, None
    h = L.attention(sub_params(p, "attn."), cfg, h,
                    kind="local" if kind == "local" else "global",
                    positions=positions, causal=causal,
                    cache=None if caches is None else caches.layer(i),
                    cache_index=cache_index,
                    tp=L.split_over_model("attn.wq", tp))
    if cfg.post_norm:
        h = L.rmsnorm(p["pn1.scale"], h, eps)
    x = x + h
    if memory is not None and "lnx.scale" in p:
        h = L.rmsnorm(p["lnx.scale"], x, eps)
        x = x + L.attention(sub_params(p, "xattn."), cfg, h,
                            positions=positions, memory=memory,
                            tp=L.split_over_model("xattn.wq", tp))
    h = L.rmsnorm(p["ln2.scale"], x, eps)
    a = None
    if kind == "moe":
        on = bool(lossy and lossy.enabled)
        h, a = MOE.moe_block(
            sub_params(p, "moe."), cfg, h, tp=tp, layer=i, lossy=on,
            coins=lossy.coins[i] if on and lossy.coins else None,
            drop_rate=lossy.drop_rate if lossy else 0.0, rows=rows)
    else:
        h = L.mlp(sub_params(p, "mlp."), cfg, h,
                  L.split_over_model("mlp.wi", tp))
    if cfg.post_norm:
        h = L.rmsnorm(p["pn2.scale"], h, eps)
    return x + h, a


def head(params: Params, cfg: ModelConfig, x: torch.Tensor,
         tp: Optional[shd.ModelGroup] = None) -> torch.Tensor:
    """Final norm and unembedding of residual-stream rows (B, S, D) ->
    logits (B, S, V) in the compute dtype (V this rank's share of the
    vocabulary when ``tp`` splits the leaf that gives them,
    :func:`logits_leaf`)."""
    x = L.rmsnorm(params["final_norm.scale"], x, cfg.norm_eps)
    return L.unembed(sub_params(params, "embed."), cfg, x,
                     L.split_over_model(logits_leaf(cfg), tp))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            caches: Optional["Caches"] = None,
            cache_index: Optional[int] = None,
            positions: Optional[torch.Tensor] = None,
            last_only: bool = False,
            tp: Optional[shd.ModelGroup] = None,
            rows: Optional[shd.RowGroup] = None,
            image_embeds: Optional[torch.Tensor] = None,
            frame_embeds: Optional[torch.Tensor] = None,
            memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, S or 1, V) in the compute dtype: :func:`hidden`, then
    :func:`head`.

    With ``caches`` the K/V of every layer are written into them in place
    (prefill, or one decode token at ``cache_index``).  With ``tp``
    (``convert.model_group``) each block whose leaves the specs split
    runs tensor parallel, and V is this rank's share of the vocabulary
    when the table is split; ``rows``: the dp ranks whose rows the MoE
    layers route together.  ``image_embeds``, ``frame_embeds`` and
    ``memory``: the frontend inputs (:func:`hidden_aux`); with
    ``image_embeds`` S counts the image positions first.
    """
    x = hidden(params, cfg, tokens, caches=caches, cache_index=cache_index,
               positions=positions, tp=tp, rows=rows,
               image_embeds=image_embeds, frame_embeds=frame_embeds,
               memory=memory)
    if last_only:   # prefill: only the last position's logits are used
        x = x[:, -1:]
    return head(params, cfg, x, tp)


def lm_loss(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor],
            tp: Optional[shd.ModelGroup] = None,
            lossy: Optional[LossyCtx] = None,
            rows: Optional[shd.RowGroup] = None, remat: bool = True):
    """Next-token cross-entropy plus the MoE aux loss.  Returns (loss,
    (nll, aux)) as JAX does; ``aux`` is 0 for the dense families.
    ``lossy``: the lossy expert dispatch (:class:`LossyCtx`); ``rows``:
    the dp ranks whose rows the MoE layers route together.

    ``batch`` holds ``tokens`` and ``labels`` (B, S_text), and, as JAX's
    ``forward`` takes them, a vision stub's ``image_embeds`` or an
    enc-dec config's ``frame_embeds`` (:func:`hidden_aux`); the loss is
    taken on the last S_text positions only, past the image positions.
    Without them a stub runs on its text alone, as the JAX trainer runs
    it: the frontend, the encoder and the cross-attention then take no
    part in the loss.

    The cross-entropy is taken in float32 with the row max shifted out,
    as in JAX.  The label logit is gathered where JAX sums a one-hot
    product: the same value, since a sum with zeros is exact.  ``remat``
    (on by default, as JAX's ``lm_loss``): the decoder and encoder stacks
    recompute each unit in the backward and, on a model group, keep the
    residual stream split over ``model`` between units (:func:`_stack`);
    the loss and every gradient are those of ``remat=False`` bit for bit.

    With the logits split over the vocabulary (``tp``, a split
    :func:`logits_leaf`) every reduction over it is the local one, then
    one over ``model``, as the JAX package writes its CE so that GSPMD
    can (``model.py:327-335``): the row max a MAX all-reduce with no gradient (JAX's
    ``stop_gradient``), the sum of ``exp`` and the label logit (0 on the
    ranks that do not hold the label) ``reduce_from_model``.  No rank
    builds logits over the whole vocabulary.
    """
    x, aux = hidden_aux(params, cfg, batch["tokens"], tp=tp, lossy=lossy,
                        rows=rows, image_embeds=batch.get("image_embeds"),
                        frame_embeds=batch.get("frame_embeds"), remat=remat)
    logits = head(params, cfg, x, tp)
    labels = batch["labels"]
    n_txt = labels.shape[1]
    logits = logits[:, -n_txt:][:, :-1]
    tgt = labels[:, 1:].long()
    vocab_tp = L.split_over_model(logits_leaf(cfg), tp)
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
    return nll.mean() + aux, (nll.mean(), aux)


@dataclasses.dataclass
class Caches:
    """The model's decode caches, laid out as the JAX model's cache tree
    (``init_caches``): ``groups[j]`` is one stacked node for layers ``j,
    j + plen, ...`` (plen = ``len(block_pattern)``; empty when the model
    has fewer layers than the pattern), then ``tail`` one per remaining
    layer.  A node is an :class:`~repro_torch.models.layers.AttnCache`
    for an attention layer, else the layer kind's recurrent state
    (``rglru.RglruCache``, ``xlstm.MlstmCache``, ``xlstm.SlstmCache``).
    A qwen2 cache is the one-group case."""
    groups: List[L.StateCache]
    tail: List[L.StateCache]

    def layer(self, i: int) -> L.StateCache:
        """Layer ``i``'s cache (views into the stacked tensors)."""
        plen = len(self.groups)
        n = plen * self.groups[0].tensors()[0].shape[0] if plen else 0
        if i < n:
            return self.groups[i % plen].layer(i // plen)
        return self.tail[i - n]

    def nodes(self) -> List[L.StateCache]:
        """Groups, then tail: the JAX tree's cache nodes in
        ``tree_leaves`` order."""
        return self.groups + self.tail

    def leaves(self) -> List[torch.Tensor]:
        """The K and V tensors in JAX's ``tree_leaves`` order (groups,
        then tail; ``k`` before ``v``): the payloads the KV transfer
        ships.  Recurrent state is no payload."""
        return [t for c in self.nodes() if isinstance(c, L.AttnCache)
                for t in (c.k, c.v)]

    @property
    def device(self) -> torch.device:
        return self.nodes()[0].tensors()[0].device

    def clone(self) -> "Caches":
        return Caches(groups=[c.clone() for c in self.groups],
                      tail=[c.clone() for c in self.tail])


def cache_split_dims(cfg: ModelConfig, tp: Optional[shd.ModelGroup]
                     ) -> Dict[str, Dict[str, int]]:
    """The port's ``model``-axis layout of the cache nodes: for each
    layer kind, {field: dim} of the fields a rank holds its slice of
    (the dim counted from the end, so the same in a stacked group node
    and a tail node); a field not named is whole on every rank.  Read
    from ``tp.split`` (:func:`~repro_torch.models.layers.
    split_over_model`), never from a local width:

    - an attention node (``global``, ``local``, ``moe``): ``k``/``v`` by
      kv heads where the layer's ``attn.wq`` splits and ``tp`` divides
      ``n_kv_heads``; else whole, as ``_proj_shard`` keeps GQA's few kv
      heads on every rank.  ``pos`` is whole;
    - ``rglru``: ``conv``/``h`` by channel of the LRU width where
      ``rglru.w_in`` splits;
    - ``mlstm``: ``c``/``n``/``m`` by head where ``mlstm.w_up`` splits
      and ``tp`` divides the heads; else whole (a column block that cuts
      a head runs every head on every rank);
    - ``slstm``: whole (the time loop runs on every rank).

    No ``tp``: every node whole."""
    out: Dict[str, Dict[str, int]] = {k: {} for k in ATTN_KINDS
                                      + RECURRENT_KINDS}
    if tp is None:
        return out
    if (L.split_over_model("attn.wq", tp) is not None
            and cfg.n_kv_heads % tp.size == 0):
        for kind in ATTN_KINDS:
            out[kind] = {"k": -2, "v": -2}
    if L.split_over_model("rglru.w_in", tp) is not None:
        out["rglru"] = {"conv": -1, "h": -1}
    if (L.split_over_model("mlstm.w_up", tp) is not None
            and cfg.n_heads % tp.size == 0):
        out["mlstm"] = {"c": -3, "n": -2, "m": -1}
    return out


def cache_kinds(cfg: ModelConfig) -> List[str]:
    """The layer kind of each node of ``cfg``'s caches, in
    :meth:`Caches.nodes` order: the pattern (when the model has a whole
    group), then the tail."""
    n_groups, tail = cfg.pattern_layout()
    return (list(cfg.block_pattern) if n_groups else []) + list(tail)


def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                device=None, tp: Optional[shd.ModelGroup] = None) -> Caches:
    """Empty caches for ``batch`` sequences of up to ``s_max`` tokens: a
    local layer's ring holds ``min(window_size, s_max)`` slots, a global
    or MoE layer's ``s_max``; a recurrent layer's state is zeros.  With
    ``tp``, a rank's caches: ``batch`` its rows, each node's split fields
    its slice (:func:`cache_split_dims`)."""
    dt = L.dtype_of(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    n_groups, _ = cfg.pattern_layout()
    dims = cache_split_dims(cfg, tp)
    recurrent = {"rglru": RG.init_cache, "mlstm": XL.init_mlstm_cache,
                 "slstm": XL.init_slstm_cache}

    def empty(kind: str, lead: tuple) -> L.StateCache:
        if kind in recurrent:        # the whole node's shapes and dtypes
            whole = recurrent[kind](cfg, batch, lead, "meta")
        else:
            sc = min(cfg.window_size, s_max) if kind == "local" else s_max
            shape = lead + (batch, sc, kv, hd)
            whole = L.AttnCache(
                k=torch.empty(shape, dtype=dt, device="meta"),
                v=torch.empty(shape, dtype=dt, device="meta"),
                pos=torch.empty(lead + (sc,), dtype=torch.int32,
                                device="meta"))
        out = []
        for f, t in zip(dataclasses.fields(whole), whole.tensors()):
            shape = list(t.shape)
            if f.name in dims[kind]:
                shape[dims[kind][f.name]] //= tp.size
            out.append(torch.full(shape, -1 if f.name == "pos" else 0,
                                  dtype=t.dtype, device=device))
        return type(whole)(*out)

    kinds = cache_kinds(cfg)
    plen = len(cfg.block_pattern) if n_groups else 0
    return Caches(groups=[empty(k, (n_groups,)) for k in kinds[:plen]],
                  tail=[empty(k, ()) for k in kinds[plen:]])


def local_caches(caches: Caches, cfg: ModelConfig, mesh,
                 tp: Optional[shd.ModelGroup] = None) -> Caches:
    """A one-device (whole) ``caches`` cut to this rank's, as
    :func:`init_caches` with ``tp`` lays them out: its dp block of the
    batch rows (``sharding_rules.cache_specs``) and its slice of each
    split field (:func:`cache_split_dims`); contiguous copies.  ``tp``:
    the rank's model group with its split leaves
    (``convert.model_group``)."""
    dims = cache_split_dims(cfg, tp)
    specs = rules.cache_specs(mesh, caches,
                              [dims[k] for k in cache_kinds(cfg)])

    def cut(c: L.StateCache, s: L.StateCache) -> L.StateCache:
        return type(c)(*(shd.local_slice(t, sp, mesh).clone()
                         for t, sp in zip(c.tensors(), s.tensors())))

    return Caches(groups=[cut(*p) for p in zip(caches.groups, specs.groups)],
                  tail=[cut(*p) for p in zip(caches.tail, specs.tail)])
