"""The port's qwen2-0.5b model against the JAX package's, at smoke size.

The JAX weights are carried across with ``params_from_jax``, so both
sides compute the same function on the same numpy prompt.  float32:
rtol/atol 2e-4 (the two frameworks order float32 sums differently).
bfloat16: atol 6.25e-2 plus rtol 2^-6, i.e. four bf16 ulps at the size
of these logits and caches (~3), since the two frameworks round to
bfloat16 at different points.  A 3,072-token prompt takes both packages'
tiled attention (``s * s > FLASH_THRESHOLD``) and is held to the same
tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import serve_step as JS
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import serve_step as TS

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2 ** -6, atol=6.25e-2)}
B, PLEN, S_MAX = 2, 16, 24


def _np(a):
    return np.asarray(a, np.float32)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg = dataclasses.replace(JC.get_smoke("qwen2-0.5b"), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke("qwen2-0.5b"), dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, PLEN))
    return dtype, jcfg, tcfg, jp, tp, prompt


def test_params_from_jax_layout(pair):
    dtype, jcfg, tcfg, jp, tp, _ = pair
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert ours.keys() == tp.keys()
    for k in ours:
        assert ours[k].shape == tp[k].shape and ours[k].dtype == tp[k].dtype, k
    assert tp["layers.1.attn.wq"].dtype == getattr(torch, dtype)
    assert tp["layers.1.ln1.scale"].dtype == torch.float32
    stacked = jp["decoder"]["groups"][0]["attn"]["wq"]
    np.testing.assert_array_equal(tp["layers.1.attn.wq"].float().numpy(),
                                  _np(stacked[1]))
    # TP padding heads are inert: zero in wq and wo on both sides
    h_hd = tcfg.n_heads * tcfg.resolved_head_dim
    for p in (ours, tp):
        assert torch.all(p["layers.0.attn.wq"][:, h_hd:] == 0)
        assert torch.all(p["layers.0.attn.wo"][h_hd:] == 0)


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm(torch.as_tensor(scale), torch.as_tensor(x), 1e-6).numpy(),
        _np(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)),
        rtol=1e-5, atol=1e-6)
    pos = np.arange(5)[None, :] + 500
    jcos, jsin, jrot = JL.rope_tables(jnp.asarray(pos), 16, 1e6, 1.0)
    tcos, tsin = TL.rope_tables(torch.as_tensor(pos), 16, 1e6)
    np.testing.assert_allclose(tcos.numpy(), _np(jcos), atol=1e-5)
    np.testing.assert_allclose(
        TL.apply_rope(torch.as_tensor(x), tcos, tsin).numpy(),
        _np(JL.apply_rope(jnp.asarray(x), jcos, jsin, jrot)), atol=2e-5)


def test_forward_logits_match_jax(pair):
    dtype, jcfg, tcfg, jp, tp, prompt = pair
    want, _, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                            remat=False)
    got = TM.forward(tp, tcfg, torch.as_tensor(prompt))
    assert got.shape == (B, PLEN, tcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_prefill_and_decode_match_jax(pair):
    dtype, jcfg, tcfg, jp, tp, prompt = pair
    jl, jc = JS.make_prefill(jcfg, S_MAX)(jp, {"tokens": jnp.asarray(prompt)})
    tl, tc = TS.make_prefill(tcfg, S_MAX)(tp, torch.as_tensor(prompt))
    _close(tl, jl, dtype)
    jcache = jc["groups"][0]["attn"]
    assert len(tc.groups) == 1 and not tc.tail
    tcache = tc.groups[0]
    assert tcache.k.shape == jcache.k.shape == (tcfg.n_layers, B, S_MAX,
                                                tcfg.n_kv_heads,
                                                tcfg.resolved_head_dim)
    _close(tcache.k, jcache.k, dtype)
    _close(tcache.v, jcache.v, dtype)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))

    # one decode step on the same token (JAX's argmax, so a near-tie in
    # bfloat16 cannot send the two sides down different tokens)
    tok = np.array(jnp.argmax(jl, -1))[:, None]
    jl2, jc2 = JS.make_decode(jcfg)(jp, jc, {"tokens": jnp.asarray(tok)},
                                    jnp.int32(PLEN))
    tl2, tc2 = TS.make_decode(tcfg)(tp, tc, torch.as_tensor(tok), PLEN)
    _close(tl2, jl2, dtype)
    jcache2 = jc2["groups"][0]["attn"]
    _close(tc2.groups[0].k, jcache2.k, dtype)
    np.testing.assert_array_equal(tc2.groups[0].pos.numpy(),
                                  np.asarray(jcache2.pos))


def test_long_prompt_prefill_tiles_and_matches_jax(pair, monkeypatch):
    """3,072 tokens: the port's tiled attention (every layer) against the
    JAX prefill's ``_flash_attention`` branch, logits and caches."""
    dtype, jcfg, tcfg, jp, tp, _ = pair
    plen, s_max = 3072, 3080
    assert plen * plen > TL.FLASH_THRESHOLD
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (1, plen))
    calls = []
    tiled = TL.tiled_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return tiled(*a, **kw)

    monkeypatch.setattr(TL, "tiled_attention", counting)
    jl, jc = JS.make_prefill(jcfg, s_max)(jp, {"tokens": jnp.asarray(prompt)})
    tl, tc = TS.make_prefill(tcfg, s_max)(tp, torch.as_tensor(prompt))
    assert len(calls) == tcfg.n_layers
    _close(tl, jl, dtype)
    jcache, tcache = jc["groups"][0]["attn"], tc.groups[0]
    _close(tcache.k, jcache.k, dtype)
    _close(tcache.v, jcache.v, dtype)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))


@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_tiled_attention_matches_dense_formula(vdtype):
    """The tiled online softmax against the dense formula on the same
    q/k/v (GQA, 3 q tiles x 3 kv tiles): float32 v to rtol/atol 1e-5;
    bfloat16 v, where the two round the probabilities to bfloat16 before
    and after normalizing and the dense output to bfloat16, to 2^-6 of
    the largest output (two bf16 ulps; ``chip_smoke.LONG_ATTN_RTOL``)."""
    g = torch.Generator().manual_seed(0)
    b, s, h, kv, d = 2, 24, 4, 2, 8
    q = torch.randn(b, s, h, d, generator=g)
    k = torch.randn(b, s, kv, d, generator=g)
    v = torch.randn(b, s, kv, d, generator=g).to(vdtype)
    pos = torch.arange(s)
    got = TL.tiled_attention(q, k.repeat_interleave(h // kv, dim=2),
                             v.repeat_interleave(h // kv, dim=2), qpos=pos,
                             kpos=pos, q_blk=8, kv_blk=8)
    want = TL.dense_attention(q, k, v, pos[None, None, None, :]
                              <= pos[None, None, :, None]).float()
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    if vdtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert (got - want).abs().max() <= 2 ** -6 * want.abs().max()


def test_init_params_seeded_and_finite():
    cfg = TC.get_smoke("qwen2-0.5b")
    a = TM.init_params(cfg, torch.Generator().manual_seed(3))
    b = TM.init_params(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["layers.0.mlp.wi"].float()
    std = cfg.d_model ** -0.5
    assert torch.all(w.abs() <= 2 * std * 1.01)
    assert 0.7 * std < w.std() < 1.0 * std      # truncation shrinks std
    logits = TM.forward(a, cfg, torch.zeros(1, 4, dtype=torch.long))
    assert torch.isfinite(logits.float()).all()


def test_unported_configs_raise():
    """Every architecture of the JAX package is ported; what still
    raises is what JAX cannot run either: an unknown name, and an
    ``"xattn"`` block kind (``ValueError``, as JAX's ``init_block``)."""
    cfg = dataclasses.replace(TC.get_smoke("qwen2-0.5b"),
                              block_pattern=("xattn",))
    with pytest.raises(ValueError, match="xattn"):
        TM.init_params(cfg, torch.Generator())
    with pytest.raises(ValueError):
        JM.init_params(jax.random.PRNGKey(0), dataclasses.replace(
            JC.get_smoke("qwen2-0.5b"), block_pattern=("xattn",)))
    for name in ("phi-4", "seamless-m4t-large"):
        with pytest.raises(ValueError):
            TC.get(name)
    for name in ("phi-3-vision-4.2b", "seamless-m4t-medium"):
        assert TC.get(name).name == name
