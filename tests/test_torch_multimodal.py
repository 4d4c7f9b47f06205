"""The port's modality stubs (phi-3-vision-4.2b's image frontend,
seamless-m4t-medium's audio frontend, encoder and cross-attention)
against the JAX package, at smoke size.

Both sides take the same numpy inputs; the JAX weights are carried
across with ``params_from_jax``.  The JAX side runs op by op
(``jax.disable_jit``) wherever bfloat16 is compared, as the port runs
eagerly.  Tolerances are ``tests/test_torch_model.py``'s: float32
rtol/atol 2e-4; bfloat16 atol 6.25e-2 plus rtol 2^-6.  Decode against a
teacher-forced forward also holds JAX's own bar, 0.05 of the largest
logit (``tests/test_models.py:78``).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import coding as jcoding
from repro.core.transport import coupling as jcoupling
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import serve_step as JS
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import unbias as tunbias
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import serve_step as TS
from repro_torch.train import train_step as TTS
from repro_torch.train.trainer import Trainer

VISION, AUDIO = "phi-3-vision-4.2b", "seamless-m4t-medium"
STUBS = [VISION, AUDIO]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2 ** -6, atol=6.25e-2)}
B, S, GEN = 2, 24, 6
N_ROT = 64
FORCED_BAR = 0.05


def _np(a):
    return np.asarray(a, np.float32)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def _eager(dtype):
    """JAX op by op where bfloat16 is compared (XLA's fusions round
    bfloat16 intermediates otherwise), jitted in float32."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _pair(arch, dtype):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed, s=S, b=B):
    """numpy tokens (b, s) and the frontend stub's embeddings (JAX's
    ``specs.token_extras`` shapes), rounded to bfloat16 as the launcher
    feeds them: {name: (jax array, tensor)}."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    n = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else s
    emb = rng.standard_normal((b, n, cfg.frontend_dim)).astype(np.float32)
    name = "image_embeds" if cfg.frontend == "vision_stub" else "frame_embeds"
    t = torch.as_tensor(emb).to(torch.bfloat16)
    return tokens, {name: (jnp.asarray(emb, jnp.bfloat16), t)}


def _jax_side(extra):
    return {k: j for k, (j, _) in extra.items()}


def _torch_side(extra):
    return {k: t for k, (_, t) in extra.items()}


def _memory(jcfg, tcfg, jp, tp, extra):
    """Both sides' encoder memory from the same frames (None without an
    encoder)."""
    if not tcfg.is_encdec:
        return None, None
    with _eager(tcfg.dtype):
        jm = JM._encode(jp, jcfg, _jax_side(extra))
    return jm, TM.encode(tp, tcfg, extra["frame_embeds"][1])


@pytest.mark.parametrize("arch", STUBS)
def test_configs_match_jax_field_for_field(arch):
    """CONFIG and SMOKE equal the JAX package's in every field,
    ``is_encdec`` and ``param_count`` included."""
    for name in ("get", "get_smoke"):
        tcfg, jcfg = getattr(TC, name)(arch), getattr(JC, name)(arch)
        assert ([f.name for f in dataclasses.fields(tcfg)]
                == [f.name for f in dataclasses.fields(jcfg)])
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert tcfg.is_encdec == jcfg.is_encdec == (arch == AUDIO)
        assert tcfg.param_count() == jcfg.param_count()
    assert TC.get(VISION).n_front == 144 and TC.get(AUDIO).n_front == 0


def test_param_count_matches_jax_for_every_arch():
    assert len(TC.ARCHS) == len(JC.ARCHS) == 10
    for arch in TC.ARCHS:
        for name in ("get", "get_smoke"):
            assert (getattr(TC, name)(arch).param_count()
                    == getattr(JC, name)(arch).param_count()), arch


@pytest.mark.parametrize("arch", STUBS)
def test_params_from_jax_carries_the_new_groups(arch):
    """The encoder stack, ``enc_norm``, ``frontend_proj`` and every
    decoder layer's ``xattn``/``lnx`` across bit for bit in bfloat16,
    with the names, shapes and dtypes ``init_params`` gives."""
    jcfg, tcfg, jp, tp = _pair(arch, "bfloat16")
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert ours.keys() == tp.keys()
    for k in ours:
        assert (ours[k].shape, ours[k].dtype) == (tp[k].shape, tp[k].dtype), k

    def same(name, want):
        got = tp[name]
        want = np.asarray(want)
        assert str(got.dtype) == f"torch.{want.dtype}", name
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
            else got.numpy(),
            want.view(np.int16) if want.dtype.name == "bfloat16" else want)

    same("frontend_proj", jp["frontend_proj"])
    assert tp["frontend_proj"].shape == (tcfg.frontend_dim, tcfg.d_model)
    if arch == VISION:
        assert not any(k.startswith(("encoder.", "enc_norm")) for k in tp)
        assert not any(".xattn." in k or ".lnx." in k for k in tp)
        return
    for i in range(tcfg.n_layers):
        dec = jp["decoder"]["groups"][0]
        same(f"layers.{i}.xattn.wq", dec["xattn"]["wq"][i])
        same(f"layers.{i}.lnx.scale", dec["lnx"]["scale"][i])
    for i in range(tcfg.encoder_layers):
        enc = jp["encoder"]["groups"][0]
        same(f"encoder.layers.{i}.attn.wk", enc["attn"]["wk"][i])
        same(f"encoder.layers.{i}.mlp.wo", enc["mlp"]["wo"][i])
        assert f"encoder.layers.{i}.xattn.wq" not in tp
    same("enc_norm.scale", jp["enc_norm"]["scale"])


def test_params_from_jax_unstacks_an_encoder_tail():
    """A 3-layer seamless with a (global, global) pattern: each stack one
    group, then a tail layer, encoder included."""
    cfg = dataclasses.replace(JC.get_smoke(AUDIO), n_layers=3,
                              encoder_layers=3,
                              block_pattern=("global", "global"))
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    assert len(jp["encoder"]["tail"]) == 1
    np.testing.assert_array_equal(
        tp["encoder.layers.2.mlp.wg"].float().numpy(),
        _np(jp["encoder"]["tail"][0]["mlp"]["wg"]))
    np.testing.assert_array_equal(
        tp["encoder.layers.1.attn.wq"].float().numpy(),
        _np(jp["encoder"]["groups"][1]["attn"]["wq"][0]))
    np.testing.assert_array_equal(
        tp["layers.2.xattn.wv"].float().numpy(),
        _np(jp["decoder"]["tail"][0]["xattn"]["wv"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(dtype):
    """``attention(memory=...)``: q from x, k/v from memory, no rotary
    and no mask, against JAX's on the same weights and inputs (decoder
    length 24 against 40 memory positions)."""
    jcfg = dataclasses.replace(JC.get_smoke(AUDIO), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke(AUDIO), dtype=dtype)
    p = JL.init_attention(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None, :]
    jdt = jnp.dtype(dtype)
    with _eager(dtype):
        want, cache = JL.attention(p, jcfg, jnp.asarray(x, jdt),
                                   memory=jnp.asarray(mem, jdt),
                                   positions=jnp.asarray(pos))
    assert cache is None
    tdt = getattr(torch, dtype)
    tparams = {k: convert._tensor(np.asarray(v)) for k, v in p.items()}
    got = TL.attention(tparams, tcfg, torch.as_tensor(x).to(tdt),
                       positions=torch.as_tensor(pos),
                       memory=torch.as_tensor(mem).to(tdt))
    assert got.dtype == tdt and got.shape == (B, S, tcfg.d_model)
    _close(got, want, dtype)
    # no rotary: the positions do not matter, in either package
    moved = TL.attention(tparams, tcfg, torch.as_tensor(x).to(tdt),
                         positions=torch.as_tensor(pos) + 100,
                         memory=torch.as_tensor(mem).to(tdt))
    assert torch.equal(moved, got)


@pytest.mark.parametrize("tiled", [False, True])
def test_noncausal_self_attention_matches_jax(tiled, monkeypatch):
    """The encoder's self-attention (``causal=False``: rotary, no mask)
    and the cross-attention against JAX's, on the dense path, and on the
    tiled path with ``FLASH_THRESHOLD`` lowered in both modules to
    route them through it (float32)."""
    cfg, tcfg = JC.get_smoke(AUDIO), TC.get_smoke(AUDIO)
    cfg = dataclasses.replace(cfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    if tiled:
        monkeypatch.setattr(JL, "FLASH_THRESHOLD", 0)
        monkeypatch.setattr(TL, "FLASH_THRESHOLD", 0)
    calls = []
    real = TL.tiled_attention
    monkeypatch.setattr(TL, "tiled_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    p = JL.init_attention(jax.random.PRNGKey(4), cfg)
    tparams = {k: convert._tensor(np.asarray(v)) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 64, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(64)[None, :]
    want, _ = JL.attention(p, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
                           causal=False)
    got = TL.attention(tparams, tcfg, torch.as_tensor(x),
                       positions=torch.as_tensor(pos), causal=False)
    _close(got, want, "float32")
    causal = TL.attention(tparams, tcfg, torch.as_tensor(x),
                          positions=torch.as_tensor(pos))
    assert (causal - got)[:, :-1].abs().max() > 1e-3   # the mask bites
    want, _ = JL.attention(p, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
                           memory=jnp.asarray(mem))
    got = TL.attention(tparams, tcfg, torch.as_tensor(x),
                       positions=torch.as_tensor(pos),
                       memory=torch.as_tensor(mem))
    _close(got, want, "float32")
    if tiled:
        assert [c["causal"] for c in calls] == [False, True, False]
    else:
        assert not calls


def test_tiled_noncausal_matches_jax_flash_over_tiles():
    """``tiled_attention(causal=False)`` against JAX's
    ``_flash_attention(causal=False)`` at 64-token tiles over 3 x 2
    tiles (a 192-position query against 128 keys, as a cross-attention
    has), float32 q/k, bfloat16 v; and against the dense formula with no
    mask."""
    cfg = JC.get_smoke(AUDIO)
    rng = np.random.default_rng(6)
    b, sq, skv, h, d = 1, 192, 128, 4, 32
    q = (rng.standard_normal((b, sq, h, d)) * 3).astype(np.float32)
    k = (rng.standard_normal((b, skv, h, d)) * 3).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    want = JL._flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v, jnp.bfloat16),
        qpos=jnp.arange(sq, dtype=jnp.int32),
        kpos=jnp.arange(skv, dtype=jnp.int32), kind="global", cfg=cfg,
        causal=False, q_blk=64, kv_blk=64)
    got = TL.tiled_attention(
        torch.as_tensor(q), torch.as_tensor(k),
        torch.as_tensor(v).to(torch.bfloat16), qpos=torch.arange(sq),
        kpos=torch.arange(skv), causal=False, q_blk=64, kv_blk=64)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL["float32"])
    dense = TL.dense_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), None)
    tiled = TL.tiled_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), qpos=torch.arange(sq),
                               kpos=torch.arange(skv), causal=False,
                               q_blk=64, kv_blk=64)
    torch.testing.assert_close(tiled, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _pair(AUDIO, dtype)
    _, extra = _inputs(tcfg, 7)
    jm, tm = _memory(jcfg, tcfg, jp, tp, extra)
    assert tm.dtype == getattr(torch, dtype)
    assert tm.shape == (B, S, tcfg.d_model)
    _close(tm, jm, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STUBS)
def test_forward_matches_jax(arch, dtype):
    """Logits with the frontend inputs: phi-3-vision over n_front + S
    positions (the image's first), seamless with its frames encoded
    inside the forward, then again with that memory given."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    tokens, extra = _inputs(tcfg, 8)
    with _eager(dtype):
        want, _, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                           **_jax_side(extra)}, remat=False)
    got = TM.forward(tp, tcfg, torch.as_tensor(tokens), **_torch_side(extra))
    assert got.shape == (B, tcfg.n_front + S, tcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    if arch == AUDIO:
        _, tm = _memory(jcfg, tcfg, jp, tp, extra)
        again = TM.forward(tp, tcfg, torch.as_tensor(tokens), memory=tm)
        assert torch.equal(again, got)
        # without memory the decoder skips its cross-attention, as JAX's
        bare = TM.forward(tp, tcfg, torch.as_tensor(tokens))
        with _eager(dtype):
            jbare, _, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                     remat=False)
        _close(bare, jbare, dtype)
        assert (bare.float() - got.float()).abs().max() > 1e-2


def test_forward_tiled_paths_match_jax(monkeypatch):
    """seamless with ``FLASH_THRESHOLD`` lowered in both modules: the
    encoder's non-causal, the decoder's causal and the cross-attention's
    tiled paths in one forward, float32, against JAX's."""
    monkeypatch.setattr(JL, "FLASH_THRESHOLD", 0)
    monkeypatch.setattr(TL, "FLASH_THRESHOLD", 0)
    jcfg, tcfg, jp, tp = _pair(AUDIO, "float32")
    tokens, extra = _inputs(tcfg, 9, s=64)
    want, _, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                       **_jax_side(extra)}, remat=False)
    got = TM.forward(tp, tcfg, torch.as_tensor(tokens), **_torch_side(extra))
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STUBS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prefill of n_front + S - 1 positions, then one decode step at
    n_front + S - 1 (with ``memory`` for seamless) as
    ``tests/test_models.py:46-78`` runs it: the port's logits and caches
    against JAX's prefill and decode on the same inputs, and the step
    against JAX's teacher-forced forward over all S tokens within JAX's
    own bar."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    tokens, extra = _inputs(tcfg, 10)
    jm, tm = _memory(jcfg, tcfg, jp, tp, extra)
    pre_j = {k: v for k, v in _jax_side(extra).items() if k == "image_embeds"}
    pre_t = {k: v for k, v in _torch_side(extra).items()
             if k == "image_embeds"}
    off = tcfg.n_front
    s_max = off + S + 4
    with _eager(dtype):
        full, _, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                           **_jax_side(extra)},
                                memory=jm, remat=False)
        jl, jc = JS.make_prefill(jcfg, s_max)(
            jp, {"tokens": jnp.asarray(tokens[:, :S - 1]), **pre_j,
                 **({"frame_embeds": _jax_side(extra)["frame_embeds"]}
                    if jm is not None else {})})
        jd, jc = JS.make_decode(jcfg)(
            jp, jc, {"tokens": jnp.asarray(tokens[:, S - 1:]),
                     **({"memory": jm} if jm is not None else {})},
            jnp.int32(off + S - 1))
    tl, tc = TS.make_prefill(tcfg, s_max)(
        tp, torch.as_tensor(tokens[:, :S - 1]), memory=tm, **pre_t)
    _close(tl, jl, dtype)
    (jnode,) = jc["groups"][0].values()
    assert len(tc.nodes()) == 1 and not tc.tail
    td, tc = TS.make_decode(tcfg)(tp, tc, torch.as_tensor(tokens[:, S - 1:]),
                                  off + S - 1, memory=tm)
    _close(td, jd, dtype)
    for name in ("k", "v"):
        _close(getattr(tc.groups[0], name), getattr(jnode, name), dtype)
    np.testing.assert_array_equal(tc.groups[0].pos.numpy(),
                                  np.asarray(jnode.pos))
    assert tc.groups[0].pos[0, :off + S].tolist() == list(range(off + S))
    want = _np(full[:, off + S - 1])
    got = td.float().numpy()
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < FORCED_BAR, (arch, err)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL["float32"])


def test_prefill_refuses_a_vision_prompt_without_its_image():
    _, tcfg, _, tp = _pair(VISION, "float32")
    with pytest.raises(ValueError, match="image_embeds"):
        TS.make_prefill(tcfg, 40)(tp, torch.zeros(1, 8, dtype=torch.long))


def test_frontend_inputs_shapes():
    g = torch.Generator().manual_seed(3)
    img = TS.frontend_inputs(TC.get(VISION), 8, 512, g)
    assert list(img) == ["image_embeds"]
    assert img["image_embeds"].shape == (8, 144, 1024)
    assert img["image_embeds"].dtype == torch.bfloat16
    frames = TS.frontend_inputs(TC.get_smoke(AUDIO), 2, 40, g)
    assert frames["frame_embeds"].shape == (2, 40, 64)
    assert TS.frontend_inputs(TC.get_smoke("qwen2-0.5b"), 2, 40, g) == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STUBS)
def test_degrade_caches_matches_jax(arch, dtype):
    """The decoder's K/V leaves (phi-3-vision's image positions
    included) shipped coded under JAX's mask and signs, against JAX's
    ``degrade_caches``; seamless's memory is no payload and comes out of
    the transfer and the decode after it bit for bit."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    tokens, extra = _inputs(tcfg, 11)
    jm, tm = _memory(jcfg, tcfg, jp, tp, extra)
    pre_j = {k: v for k, v in _jax_side(extra).items() if k == "image_embeds"}
    pre_t = {k: v for k, v in _torch_side(extra).items()
             if k == "image_embeds"}
    n_ctx = tcfg.n_front + S
    with _eager(dtype):
        _, jc = JS.make_prefill(jcfg, n_ctx + GEN)(
            jp, {"tokens": jnp.asarray(tokens), **pre_j,
                 **({"frame_embeds": _jax_side(extra)["frame_embeds"]}
                    if jm is not None else {})})
    logits, tc = TS.make_prefill(tcfg, n_ctx + GEN)(
        tp, torch.as_tensor(tokens), memory=tm, **pre_t)
    mask = jcoupling.kv_hole_masks(np.array([0.9]), N_ROT, seed=1)[0]
    key = jax.random.PRNGKey(42)
    signs = torch.as_tensor(np.array(jcoding.rademacher(
        key, jcoding.plan(int(tc.leaves()[0].numel()), n_rot=N_ROT))))
    jdeg = JS.degrade_caches(jc, jnp.asarray(mask), key)
    mem_before = None if tm is None else tm.clone()
    tdeg = TS.degrade_caches(tc, torch.as_tensor(mask), signs=signs)
    (jnode,) = jdeg["groups"][0].values()
    assert len(tdeg.leaves()) == 2
    tol = dict(rtol=0.0, atol=1e-5) if dtype == "float32" else TOL[dtype]
    for g, w in ((tdeg.groups[0].k, jnode.k), (tdeg.groups[0].v, jnode.v)):
        np.testing.assert_allclose(g.float().numpy(), _np(w), **tol)
    np.testing.assert_allclose(
        TS.kv_position_error(tc, tdeg, n_ctx).numpy(),
        _np(JS.kv_position_error(jc, jdeg, n_ctx)),
        rtol=2e-2 if dtype == "bfloat16" else 1e-4, atol=1e-4)
    TS.greedy_decode(tcfg, tp, tdeg, torch.argmax(logits, -1)[:, None],
                     n_ctx, GEN, memory=tm)
    if tm is not None:
        assert torch.equal(tm, mem_before)


@pytest.mark.parametrize("arch", STUBS)
def test_greedy_decode_without_memory_matches_jax(arch):
    """``greedy_decode(memory=None)`` is JAX's loop token for token
    (float32): for seamless that loop runs without the cross-attention,
    as JAX's ``serve_step.py:70`` does; and ``greedy_generate`` equals a
    JAX loop that starts at n_front + S and passes the memory to every
    step, the loop the two reference faults leave out."""
    jcfg, tcfg, jp, tp = _pair(arch, "float32")
    tokens, extra = _inputs(tcfg, 12)
    jm, tm = _memory(jcfg, tcfg, jp, tp, extra)
    pre_j = {k: v for k, v in _jax_side(extra).items() if k == "image_embeds"}
    pre_t = {k: v for k, v in _torch_side(extra).items()
             if k == "image_embeds"}
    start = tcfg.n_front + S
    jprefill = JS.make_prefill(jcfg, start + GEN)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(tokens), **_jax_side(extra)})
    first = jnp.argmax(jl, -1)[:, None]
    want = JS.greedy_decode(jcfg, jp, jc, first, start, GEN)
    tl, tc = TS.make_prefill(tcfg, start + GEN)(
        tp, torch.as_tensor(tokens), memory=tm, **pre_t)
    got = TS.greedy_decode(tcfg, tp, tc, torch.argmax(tl, -1)[:, None],
                           start, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the loop with memory at every step, from position n_front + S
    jdec = JS.make_decode(jcfg)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(tokens), **_jax_side(extra)})
    out = [jnp.argmax(jl, -1)[:, None]]
    for i in range(GEN - 1):
        jl, jc = jdec(jp, jc, {"tokens": out[-1],
                               **({"memory": jm} if jm is not None else {})},
                      jnp.int32(start + i))
        out.append(jnp.argmax(jl, -1)[:, None])
    got = TS.greedy_generate(tcfg, tp, torch.as_tensor(tokens), GEN,
                             extra=_torch_side(extra))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(out, 1)))


@pytest.mark.parametrize("arch", STUBS)
def test_serve_launcher_smoke_on_cpu(arch, capsys):
    tfwht.launches = tunbias.launches = 0
    out = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "4",
                        "--kv-frac", "0.9"])
    assert out.shape == (2, 4)
    printed = capsys.readouterr().out
    assert "wire rows lost, coded" in printed
    assert ("encoder memory (2, 16, 128)" in printed) == (arch == AUDIO)
    assert tfwht.launches == 0 and tunbias.launches == 0


@pytest.mark.parametrize("arch", STUBS)
def test_training_refuses_the_stubs(arch):
    """The stubs train (their leaf view, backward and steps are held to
    JAX's in ``tests/test_torch_train_stubs.py``): the step, the state
    and the Trainer build, the state holds the view's leaves
    (``frontend_proj``; seamless's encoder stack and cross-attention),
    and one CPU Trainer step on text alone runs."""
    cfg = TC.get_smoke(arch)
    step = TTS.make_train_step(cfg)
    state = TTS.init_state(torch.Generator(), cfg)
    tr = Trainer(cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=2),
                 device="cpu")
    names = convert.leaf_names(cfg)
    assert callable(step) and len(state["params"]) == len(names)
    assert [tuple(x.shape) for x in state["params"]] == \
        convert.leaf_shapes(cfg)
    assert "frontend_proj" in names
    assert ("encoder.groups[0].attn.wq" in names) == (arch == AUDIO)
    hist = tr.run(1)
    assert np.isfinite(hist["loss"]).all() and int(tr.state["step"]) == 1
