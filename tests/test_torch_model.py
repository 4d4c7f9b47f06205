"""The port's qwen2-0.5b model against the JAX package's, at smoke size.

The JAX weights are carried across with ``params_from_jax``, so both
sides compute the same function on the same numpy prompt.  float32:
rtol/atol 2e-4 (the two frameworks order float32 sums differently).
bfloat16: atol 6.25e-2 plus rtol 2^-6, i.e. four bf16 ulps at the size
of these logits and caches (~3), since the two frameworks round to
bfloat16 at different points.
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
    assert tc.k.shape == jcache.k.shape == (tcfg.n_layers, B, S_MAX,
                                            tcfg.n_kv_heads,
                                            tcfg.resolved_head_dim)
    _close(tc.k, jcache.k, dtype)
    _close(tc.v, jcache.v, dtype)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jcache.pos))

    # one decode step on the same token (JAX's argmax, so a near-tie in
    # bfloat16 cannot send the two sides down different tokens)
    tok = np.array(jnp.argmax(jl, -1))[:, None]
    jl2, jc2 = JS.make_decode(jcfg)(jp, jc, {"tokens": jnp.asarray(tok)},
                                    jnp.int32(PLEN))
    tl2, tc2 = TS.make_decode(tcfg)(tp, tc, torch.as_tensor(tok), PLEN)
    _close(tl2, jl2, dtype)
    jcache2 = jc2["groups"][0]["attn"]
    _close(tc2.k, jcache2.k, dtype)
    np.testing.assert_array_equal(tc2.pos.numpy(), np.asarray(jcache2.pos))


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
    cfg = dataclasses.replace(TC.get_smoke("qwen2-0.5b"),
                              block_pattern=("local",))
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, torch.Generator())
    with pytest.raises(ValueError):
        TC.get("gemma2-9b")
