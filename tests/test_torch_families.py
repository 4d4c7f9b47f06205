"""The port's dense families (gemma2-9b, chatglm3-6b, nemotron-4-15b)
against the JAX package's, at smoke size; the tests that apply to any
family unchanged also take the recurrent ones (recurrentgemma-9b,
xlstm-350m; their blocks are in ``tests/test_torch_recurrent.py``).

The JAX weights are carried across with ``params_from_jax``, so both
sides compute the same function on the same numpy prompt.  Tolerances
are ``tests/test_torch_model.py``'s: float32 rtol/atol 2e-4; bfloat16
atol 6.25e-2 plus rtol 2^-6.  gemma2's smoke config has a 64-token
window, so a 96-token prompt wraps its local layers' ring caches.
"""
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

FAMILIES = ["gemma2-9b", "chatglm3-6b", "nemotron-4-15b"]
RECURRENT = ["recurrentgemma-9b", "xlstm-350m"]
STUBS = ["phi-3-vision-4.2b", "seamless-m4t-medium"]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2 ** -6, atol=6.25e-2)}
B, PLEN, S_MAX = 2, 16, 24
RING_PLEN, RING_GEN = 96, 8          # over gemma2's 64-token smoke window
N_ROT = 64


def _np(a):
    return np.asarray(a, np.float32)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def _pair(arch, dtype, **kw):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype=dtype, **kw)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _jax_nodes(jc):
    """The JAX cache tree's nodes (an AttnCache, or a layer kind's
    recurrent state), each the one value of its layer's dict: groups,
    then tail."""
    nodes = []
    for n in list(jc["groups"]) + list(jc["tail"]):
        (node,) = n.values()
        nodes.append(node)
    return nodes


def _close_caches(tc: TM.Caches, jc, dtype):
    """Every node of the tree against JAX's, field by field in the
    dataclass order: shapes and dtypes equal, ``pos`` exact, the rest at
    ``dtype``'s tolerance."""
    nodes = _jax_nodes(jc)
    assert len(tc.nodes()) == len(nodes)
    for got, want in zip(tc.nodes(), nodes):
        assert type(got).__name__ == type(want).__name__
        fields = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == fields
        for name in fields:
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert tuple(g.shape) == w.shape, name
            assert str(g.dtype) == f"torch.{w.dtype}", (name, g.dtype)
            if name == "pos":
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                _close(g, w, dtype)


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_layout(arch):
    jcfg, tcfg, jp, tp = _pair(arch, "bfloat16")
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert ours.keys() == tp.keys()
    for k in ours:
        assert (ours[k].shape, ours[k].dtype) == (tp[k].shape, tp[k].dtype), k
    groups = jp["decoder"]["groups"]
    plen = len(tcfg.block_pattern)
    assert len(groups) == plen and not jp["decoder"]["tail"]
    for i in range(tcfg.n_layers):     # layer i <- groups[i % plen][i // plen]
        want = groups[i % plen]["attn"]["wq"][i // plen]
        np.testing.assert_array_equal(
            tp[f"layers.{i}.attn.wq"].float().numpy(), _np(want))
    if tcfg.post_norm:
        assert tp["layers.3.pn2.scale"].dtype == torch.float32
    assert ("layers.0.mlp.wg" in tp) == (tcfg.mlp_type != "sqrelu")
    if tcfg.tie_embeddings:
        assert "embed.unembed" not in tp
    else:
        np.testing.assert_array_equal(tp["embed.unembed"].float().numpy(),
                                      _np(jp["embed"]["unembed"]))
        assert tp["embed.unembed"].shape == (tcfg.d_model, tcfg.vocab_size)


def test_params_from_jax_tail_layer():
    """A 3-layer gemma2: one (local, global) group, then a local tail."""
    jcfg, tcfg, jp, tp = _pair("gemma2-9b", "float32", n_layers=3)
    assert len(jp["decoder"]["tail"]) == 1
    np.testing.assert_array_equal(
        tp["layers.2.mlp.wg"].numpy(),
        _np(jp["decoder"]["tail"][0]["mlp"]["wg"]))
    assert TM.init_params(tcfg, torch.Generator()).keys() == tp.keys()
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, PLEN))
    jl, jc = JS.make_prefill(jcfg, S_MAX)(jp, {"tokens": jnp.asarray(prompt)})
    tl, tc = TS.make_prefill(tcfg, S_MAX)(tp, torch.as_tensor(prompt))
    assert len(tc.groups) == 2 and len(tc.tail) == 1
    _close(tl, jl, "float32")
    _close_caches(tc, jc, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES + RECURRENT)
def test_forward_logits_match_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (B, RING_PLEN))
    want, _, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                            remat=False)
    got = TM.forward(tp, tcfg, torch.as_tensor(prompt))
    assert got.shape == (B, RING_PLEN, tcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES + RECURRENT)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prefill, then decode steps, logits and every cache leaf (k, v,
    pos; a recurrent layer's state) against JAX's.  gemma2 and
    recurrentgemma also run a 96-token prompt over their 64-token window:
    the ring prefill wraps and 8 decode steps write past it.  The tokens
    fed are JAX's argmax, so a near-tie in bfloat16 cannot send the two
    sides down different tokens."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    cases = [(PLEN, S_MAX - PLEN)]
    if "local" in tcfg.block_pattern:
        assert RING_PLEN > tcfg.window_size
        cases.append((RING_PLEN, RING_GEN))
    for plen, gen in cases:
        prompt = np.random.default_rng(plen).integers(0, jcfg.vocab_size,
                                                      (B, plen))
        jl, jc = JS.make_prefill(jcfg, plen + gen)(
            jp, {"tokens": jnp.asarray(prompt)})
        tl, tc = TS.make_prefill(tcfg, plen + gen)(tp, torch.as_tensor(prompt))
        _close(tl, jl, dtype)
        _close_caches(tc, jc, dtype)
        jdec, tdec = JS.make_decode(jcfg), TS.make_decode(tcfg)
        for idx in range(plen, plen + gen):
            tok = np.array(jnp.argmax(jl, -1))[:, None]
            jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok)}, jnp.int32(idx))
            tl, tc = tdec(tp, tc, torch.as_tensor(tok), idx)
            _close(tl, jl, dtype)
        _close_caches(tc, jc, dtype)


@pytest.mark.parametrize("arch", FAMILIES + RECURRENT)
def test_greedy_tokens_identical_f32(arch):
    jcfg, tcfg, jp, tp = _pair(arch, "float32")
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                               (B, RING_PLEN))
    want = JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), RING_GEN)
    got = TS.greedy_generate(tcfg, tp, torch.as_tensor(prompt), RING_GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["local", "global"])
def test_tiled_attention_matches_jax_flash(kind):
    """The port's tiled attention with gemma2's softcap (and window, for
    a local layer) against JAX's ``_flash_attention`` at q_blk = kv_blk
    = 64 over 3 x 3 tiles, on the same float32 q/k/v, bfloat16 v."""
    cfg = JC.get_smoke("gemma2-9b")
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 192, 4, 32
    q = (rng.standard_normal((b, s, h, d)) * 3).astype(np.float32)
    k = (rng.standard_normal((b, s, h, d)) * 3).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want = JL._flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v, jnp.bfloat16),
        qpos=jnp.asarray(pos), kpos=jnp.asarray(pos), kind=kind, cfg=cfg,
        causal=True, q_blk=64, kv_blk=64)
    got = TL.tiled_attention(
        torch.as_tensor(q), torch.as_tensor(k),
        torch.as_tensor(v).to(torch.bfloat16), qpos=torch.as_tensor(pos),
        kpos=torch.as_tensor(pos), softcap=cfg.attn_softcap,
        window=cfg.window_size if kind == "local" else None,
        q_blk=64, kv_blk=64)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL["float32"])
    # the window bites: the last query's local output differs from global
    if kind == "local":
        glob = TL.tiled_attention(
            torch.as_tensor(q), torch.as_tensor(k),
            torch.as_tensor(v).to(torch.bfloat16), qpos=torch.as_tensor(pos),
            kpos=torch.as_tensor(pos), softcap=cfg.attn_softcap,
            q_blk=64, kv_blk=64)
        assert (glob[0, -1] - got[0, -1]).abs().max() > 1e-3


def test_tiled_matches_dense_softcap_window():
    """The tiled path against the port's dense formula, softcap and local
    window, float32 v: rtol/atol 1e-5 (the two sum in other orders)."""
    g = torch.Generator().manual_seed(0)
    b, s, h, kv, d = 2, 96, 4, 2, 16
    q = torch.randn(b, s, h, d, generator=g) * 4
    k = torch.randn(b, s, kv, d, generator=g) * 4
    v = torch.randn(b, s, kv, d, generator=g)
    pos = torch.arange(s)
    kp, qp = pos[None, None, None, :], pos[None, None, :, None]
    got = TL.tiled_attention(q, k.repeat_interleave(h // kv, dim=2),
                             v.repeat_interleave(h // kv, dim=2), qpos=pos,
                             kpos=pos, softcap=50.0, window=40, q_blk=32,
                             kv_blk=32)
    want = TL.dense_attention(q, k, v, (kp <= qp) & (kp > qp - 40), 50.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_partial_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)[None, :] + 700
    jcos, jsin, jrot = JL.rope_tables(jnp.asarray(pos), 16, 1e4, 0.5)
    tcos, tsin = TL.rope_tables(torch.as_tensor(pos), 16, 1e4, 0.5)
    assert jrot == 8 and tcos.shape == (1, 5, 4)
    np.testing.assert_allclose(tcos.numpy(), _np(jcos), atol=1e-5)
    got = TL.apply_rope(torch.as_tensor(x), tcos, tsin)
    np.testing.assert_allclose(
        got.numpy(), _np(JL.apply_rope(jnp.asarray(x), jcos, jsin, jrot)),
        atol=2e-5)
    np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])
    # bfloat16 input: the rotated half is float32, the rest cast to it
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert TL.apply_rope(xb, tcos, tsin).dtype == torch.float32


def _gemma2_caches(dtype, plen):
    jcfg, tcfg, jp, tp = _pair("gemma2-9b", dtype)
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, plen))
    _, jc = JS.make_prefill(jcfg, plen + RING_GEN)(
        jp, {"tokens": jnp.asarray(prompt)})
    _, tc = TS.make_prefill(tcfg, plen + RING_GEN)(tp, torch.as_tensor(prompt))
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("coded", [True, False])
def test_degrade_caches_matches_jax_on_gemma2(dtype, coded):
    """A gemma2 cache tree (a local ring group and a global group): every
    K/V leaf shipped with its own plan, JAX's per-leaf signs carried
    across; the leaves against JAX's, and kv_position_error."""
    jc, tc = _gemma2_caches(dtype, PLEN)
    mask = jcoupling.kv_hole_masks(np.array([0.9]), N_ROT, seed=1)[0]
    key = jax.random.PRNGKey(42)
    signs = [torch.as_tensor(np.array(jcoding.rademacher(
        key, jcoding.plan(int(t.numel()), n_rot=N_ROT)))) for t in tc.leaves()]
    jdeg = JS.degrade_caches(jc, jnp.asarray(mask), key, coded=coded)
    tdeg = TS.degrade_caches(tc, torch.as_tensor(mask), coded=coded,
                             signs=signs)
    tol = dict(rtol=0.0, atol=1e-5) if dtype == "float32" else TOL[dtype]
    assert len(tdeg.leaves()) == 4
    for got, want, clean in zip(tdeg.nodes(), _jax_nodes(jdeg), tc.nodes()):
        for g, w, c in ((got.k, want.k, clean.k), (got.v, want.v, clean.v)):
            assert g.dtype == c.dtype and g.shape == c.shape
            np.testing.assert_allclose(g.float().numpy(), _np(w), **tol)
        assert torch.equal(got.pos, clean.pos)
        assert got.pos.data_ptr() != clean.pos.data_ptr()
    want_err = JS.kv_position_error(jc, jdeg, PLEN)
    got_err = TS.kv_position_error(tc, tdeg, PLEN)
    np.testing.assert_allclose(got_err.numpy(), _np(want_err),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-4,
                               atol=1e-4)
    # one sign vector for every leaf is JAX's draw too: all plans have
    # the mask's n_rot rows
    if coded:
        one = TS.degrade_caches(tc, torch.as_tensor(mask), signs=signs[0])
        for a, b in zip(one.leaves(), tdeg.leaves()):
            assert torch.equal(a, b)


def test_kv_position_error_refuses_wrapped_ring():
    jc, tc = _gemma2_caches("float32", RING_PLEN)
    assert tc.groups[0].k.shape[2] == 64 < RING_PLEN    # the wrapped ring
    deg = TS.degrade_caches(tc, torch.ones(N_ROT, dtype=torch.bool),
                            torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="ring cache that wrapped"):
        TS.kv_position_error(tc, deg, RING_PLEN)
    # JAX fails on the same input in its reshape
    with pytest.raises(TypeError):
        JS.kv_position_error(jc, jc, RING_PLEN)
    assert float(TS.kv_position_error(tc, deg, 64).max()) < 1e-5


def test_degrade_caches_sign_count_must_match():
    _, tc = _gemma2_caches("float32", PLEN)
    with pytest.raises(ValueError, match="sign vectors"):
        TS.degrade_caches(tc, torch.ones(N_ROT, dtype=torch.bool),
                          signs=[torch.ones(N_ROT)] * 3)


def test_caches_layout_and_layer_views():
    cfg = TC.get_smoke("gemma2-9b")
    c = TM.init_caches(cfg, 2, 100)
    assert [n.k.shape for n in c.groups] == [(2, 2, 64, 2, 32),
                                             (2, 2, 100, 2, 32)]
    assert c.layer(2).k.data_ptr() == c.groups[0].k[1].data_ptr()
    assert c.layer(3).pos.shape == (100,)
    assert [t.shape[2] for t in c.leaves()] == [64, 64, 100, 100]
    qwen = TM.init_caches(TC.get_smoke("qwen2-0.5b"), 2, 24)
    assert len(qwen.groups) == 1 and not qwen.tail
    assert qwen.groups[0].k.shape == (2, 2, 24, 1, 18)
    short = TM.init_caches(dataclasses.replace(cfg, n_layers=1), 1, 8)
    assert not short.groups and short.layer(0).k.shape == (1, 8, 2, 32)


def test_serve_launcher_gemma2_smoke_on_cpu(capsys):
    tfwht.launches = tunbias.launches = 0
    out = tlaunch.main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "80", "--gen", "4",
                        "--kv-frac", "0.9"])
    assert out.shape == (2, 4)
    assert "wire rows lost, coded" in capsys.readouterr().out
    assert tfwht.launches == 0 and tunbias.launches == 0


@pytest.mark.parametrize("arch", FAMILIES + RECURRENT)
def test_training_refuses_the_families(arch):
    """The dense and recurrent families train (their leaf views and
    backward are held to JAX's in ``tests/test_torch_train_families.py``
    and ``tests/test_torch_train_recurrent.py``): the step, the state
    and the Trainer build, the state holds the view's leaves, and one
    CPU step runs."""
    cfg = TC.get_smoke(arch)
    step = TTS.make_train_step(cfg)
    state = TTS.init_state(torch.Generator(), cfg)
    tr = Trainer(cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=2),
                 device="cpu")
    assert callable(step)
    assert [tuple(x.shape) for x in state["params"]] == \
        convert.leaf_shapes(cfg)
    hist = tr.run(1)
    assert np.isfinite(hist["loss"]).all() and int(tr.state["step"]) == 1


@pytest.mark.parametrize("arch", FAMILIES + RECURRENT + STUBS)
def test_tensor_parallel_runs_every_family(arch):
    """Tensor parallelism runs for every family (held to JAX's steps in
    ``tests/test_torch_train_families_mesh.py`` and
    ``tests/test_torch_tp_recurrent_stubs.py``): on a (1, 2) mesh of a
    fake process group the step builds, each rank holds its shards, and
    the forward (a stub's with its frontend inputs) gives its half of the
    vocabulary."""
    from repro_torch.launch import mesh as tmesh
    from test_torch_dp_train import fake_world
    cfg = TC.get_smoke(arch)
    tokens = torch.zeros(1, 4, dtype=torch.long)
    extras, n_img = {}, 0
    if cfg.frontend == "vision_stub":
        n_img = cfg.n_frontend_tokens
        extras["image_embeds"] = torch.zeros(1, n_img, cfg.frontend_dim)
    if cfg.is_encdec:
        extras["frame_embeds"] = torch.zeros(1, 4, cfg.frontend_dim)
    with fake_world(2):
        mesh = tmesh.make_host_mesh((1, 2), device_type="cpu")
        tp = TTS.make_train_step(cfg, mesh).model_group
        shards = TTS.init_state(torch.Generator().manual_seed(0), cfg,
                                mesh)["params"]
        assert tp.size == 2 and TM.logits_leaf(cfg) in tp.split
        assert [tuple(x.shape) for x in shards] != convert.leaf_shapes(cfg)
        logits = TM.forward(convert.params_from_leaves(shards, cfg), cfg,
                            tokens, tp=tp, **extras)
    assert logits.shape == (1, n_img + 4, cfg.vocab_size // 2)


def test_ring_decode_matches_teacher_forced_forward():
    """chip_smoke's long-prompt check at smoke size, float32: decoding
    through gemma2's wrapped ring, the last step's logits against
    ``head(hidden(...))`` of a forward over the same tokens padded with
    filler (causal masks keep it out), unembedded at that position only;
    and the forward's logits there against ``forward``'s."""
    cfg = dataclasses.replace(TC.get_smoke("gemma2-9b"), dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, RING_PLEN),
                           generator=torch.Generator().manual_seed(1))
    logits, caches = TS.make_prefill(cfg, RING_PLEN + RING_GEN)(params,
                                                                 prompt)
    toks = TS.greedy_decode(cfg, params, caches, torch.argmax(logits, -1)[
        :, None], RING_PLEN, RING_GEN)
    last = RING_PLEN + RING_GEN - 1
    got, _ = TS.make_decode(cfg)(params, caches, toks[:, -1:], last)
    seq = torch.nn.functional.pad(torch.cat([prompt, toks], 1), (0, 24))
    want = TM.head(params, cfg, TM.hidden(params, cfg, seq)[:, last:last + 1])
    torch.testing.assert_close(got, want[:, 0], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(TM.forward(params, cfg, seq)[:, last],
                               want[:, 0], rtol=1e-5, atol=1e-5)


def test_kv_wire_check_over_a_cache_tree(monkeypatch):
    """chip_smoke.check_kv_wire on a gemma2 cache tree whose leaves have
    two sizes (a wrapped 64-slot ring and a global cache), the plain
    versions standing in for the kernels: every leaf's shapes, error 0,
    and the timed records at the first leaf's shapes."""
    import types

    import chip_smoke
    from repro_torch.core import coding
    from repro_torch.kernels import ref
    _, tc = _gemma2_caches("float32", RING_PLEN)
    mask = torch.as_tensor(
        jcoupling.kv_hole_masks(np.array([0.9]), N_ROT, seed=1)[0])
    signs = coding.rademacher(torch.Generator().manual_seed(2),
                              coding.plan(tc.leaves()[0].numel(), N_ROT))
    kfwht = types.SimpleNamespace(
        fwht_cuda=lambda x, s, sc: ref.fwht(x, signs=s, scale=sc))
    kunbias = types.SimpleNamespace(masked_unbias_cuda=ref.masked_unbias)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, cold=False: 0.0)
    out = chip_smoke.check_kv_wire("tree", tc, mask, signs, kfwht, kunbias,
                                   ref, coding, timed=True)
    sizes = sorted({t.numel() // N_ROT for t in tc.leaves()})
    assert out["max_abs_err"] == {"fwht": 0.0, "masked_unbias": 0.0}
    assert out["shapes"] == sorted(
        [f"fwht [{n}, {N_ROT}]" for n in sizes]
        + [f"masked_unbias [{N_ROT}, {n}]" for n in sizes])
    assert [r["shape"] for r in out["records"]] == [[sizes[0], N_ROT],
                                                    [N_ROT, sizes[0]]]
