"""The port's recurrent blocks (RG-LRU, mLSTM, sLSTM) and the recurrent
families' cache trees against the JAX package, at smoke size.

Both sides take the same numpy inputs and the same weights (the JAX
block's own, or a JAX model's carried across with ``params_from_jax``).
Tolerances: float32 rtol/atol 2e-5 on a block (the doubling scan and the
chunkwise mLSTM associate in other orders than XLA: not bit for bit);
bfloat16 blocks atol 6.25e-2 plus rtol 2^-6 (``tests/test_torch_model.
py``'s) against JAX run op by op (``jax.disable_jit``), as the port runs
eagerly.  The whole models' logits, prefill, decode and greedy tokens
are ``tests/test_torch_families.py``'s cases.
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
from repro.models import rglru as JRG
from repro.models import xlstm as JXL
from repro.serve import serve_step as JS
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import unbias as tunbias
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rglru as TRG
from repro_torch.models import xlstm as TXL
from repro_torch.serve import serve_step as TS

RECURRENT = ["recurrentgemma-9b", "xlstm-350m"]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2 ** -6, atol=6.25e-2)}
N_ROT = 64


def _np(a):
    return np.asarray(a, np.float32)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def _block_params(init, key, cfg):
    """JAX ``init`` at ``cfg``, every float32 gate vector given random
    values (they init to zeros), and the same weights as tensors."""
    p = dict(init(jax.random.PRNGKey(key), cfg))
    rng = np.random.default_rng(key)
    for k in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
        if k in p:
            p[k] = jnp.asarray(
                rng.standard_normal(p[k].shape).astype(np.float32) * 0.5)
    return p, {k: convert._tensor(np.asarray(v)) for k, v in p.items()}


def _cfgs(arch, dtype):
    return (dataclasses.replace(JC.get_smoke(arch), dtype=dtype),
            dataclasses.replace(TC.get_smoke(arch), dtype=dtype))


def _jax_run(dtype, fn, *a, **k):
    if dtype == "bfloat16":
        with jax.disable_jit():
            return fn(*a, **k)
    return fn(*a, **k)


# ----------------------------------------------------------------------
# RG-LRU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 37, 1024])
def test_rglru_block_matches_jax(s, dtype):
    """S = 1 (the decode step), 37 (one scan) and 1,024 (JAX's chunked
    path, two chunks of 512), each from a non-zero cache (conv window and
    h): the output, the new h, and the new conv state bit for bit."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b", dtype)
    jp, tp = _block_params(JRG.init_rglru, 8, jcfg)
    rng = np.random.default_rng(s)
    w = jcfg.lru_width
    x = (rng.standard_normal((2, s, jcfg.d_model)) * 0.5).astype(np.float32)
    conv = rng.standard_normal((2, 3, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want, wc = _jax_run(dtype, JRG.rglru_block, jp, jcfg,
                        jnp.asarray(x, jdt), cache=JRG.RglruCache(
                            jnp.asarray(conv, jdt), jnp.asarray(h0)))
    tdt = getattr(torch, dtype)
    got, gc = TRG.rglru_block(tp, tcfg, torch.as_tensor(x).to(tdt),
                              cache=TRG.RglruCache(
                                  torch.as_tensor(conv).to(tdt),
                                  torch.as_tensor(h0)))
    assert got.dtype == tdt and got.shape == (2, s, jcfg.d_model)
    assert gc.h.dtype == torch.float32 and gc.conv.dtype == tdt
    _close(got, want, dtype)
    _close(gc.h, wc.h, dtype)
    np.testing.assert_array_equal(gc.conv.float().numpy(), _np(wc.conv))


def test_rglru_without_cache_is_a_zero_cache():
    """No cache: h0 and the conv window are zeros and no cache comes
    back, as in JAX."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b", "float32")
    _, tp = _block_params(JRG.init_rglru, 3, jcfg)
    x = torch.randn(2, 20, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    out, none = TRG.rglru_block(tp, tcfg, x)
    assert none is None
    zero = TRG.init_cache(tcfg, 2)
    out2, _ = TRG.rglru_block(tp, tcfg, x, cache=zero)
    assert torch.equal(out, out2)


def test_causal_conv_state_matches_jax():
    """The new conv state is the last 3 pre-conv inputs: for S >= 3 the
    input's tail, for S = 1 the old window shifted by one; equal to
    JAX's bit for bit, and so is the convolution at float32."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b", "float32")
    jp, tp = _block_params(JRG.init_rglru, 5, jcfg)
    rng = np.random.default_rng(1)
    prev = rng.standard_normal((2, 3, jcfg.lru_width)).astype(np.float32)
    for s in (1, 2, 9):
        u = rng.standard_normal((2, s, jcfg.lru_width)).astype(np.float32)
        wo, wp = JRG._causal_conv(jp, jnp.asarray(u), jnp.asarray(prev))
        go, gp = TRG._causal_conv(tp, torch.as_tensor(u),
                                  torch.as_tensor(prev))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        want_tail = np.concatenate([prev, u], 1)[:, -3:]
        np.testing.assert_array_equal(gp.numpy(), want_tail)
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-6,
                                   atol=1e-6)


def test_cell_coeffs_match_jax():
    """(a_t, b_t) against JAX's over lam from below the init's range
    (about -8.3 to -3.6) to above ``torch.nn.functional.softplus``'s
    threshold of 20 (the port takes JAX's ``logaddexp(x, 0)``)."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b", "float32")
    jp, tp = _block_params(JRG.init_rglru, 2, jcfg)
    lam = np.linspace(-9.0, 25.0, jcfg.lru_width).astype(np.float32)
    jp["lam"], tp["lam"] = jnp.asarray(lam), torch.as_tensor(lam)
    u = np.random.default_rng(0).standard_normal(
        (3, jcfg.lru_width)).astype(np.float32)
    wa, wb = JRG._cell_coeffs(jp, jnp.asarray(u))
    ga, gb = TRG._cell_coeffs(tp, torch.as_tensor(u))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("s", [1, 2, 5, 512, 700])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan against the step-by-step recurrence in float64
    (ceil(log2 s) doubling steps; no power of two needed)."""
    g = torch.Generator().manual_seed(s)
    a = torch.rand(3, s, 4, generator=g, dtype=torch.float64)
    b = torch.randn(3, s, 4, generator=g, dtype=torch.float64)
    h = torch.zeros(3, 4, dtype=torch.float64)
    want = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(TRG.linear_scan(a, b),
                               torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


# ----------------------------------------------------------------------
# mLSTM and sLSTM
# ----------------------------------------------------------------------

def _mlstm_inputs(s, rng, b=2, h=2, d=16):
    f = np.float32
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(f) * 0.3
               for _ in range(3))
    logi = rng.standard_normal((b, s, h)).astype(f)
    logf = np.log(1 / (1 + np.exp(-rng.standard_normal((b, s, h)) - 2))
                  ).astype(f)
    c0 = rng.standard_normal((b, h, d, d)).astype(f) * 0.2
    n0 = rng.standard_normal((b, h, d)).astype(f) * 0.2
    m0 = rng.standard_normal((b, h)).astype(f)
    return q, k, v, logi, logf, c0, n0, m0


@pytest.mark.parametrize("fn", ["mlstm_parallel", "_mlstm_seq"])
def test_mlstm_forms_match_jax(fn):
    """Both mLSTM forms from a non-zero state, on the same float32
    inputs: the outputs and the (C, n, m) state.  (The two forms agree
    with each other only where the normalizer's floor of 1 does not
    bind, since each floors its own stabilized value; each is held to
    its JAX counterpart.)"""
    args = _mlstm_inputs(128, np.random.default_rng(0))
    want, wst = getattr(JXL, fn)(*map(jnp.asarray, args))
    got, gst = getattr(TXL, fn)(*map(torch.as_tensor, args))
    _close(got, want, "float32")
    for g, w in zip(gst, wst):
        _close(g, w, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 50, 128])
def test_mlstm_block_matches_jax(s, dtype):
    """The block from a non-zero cache at S = 1 (the sequential step), 50
    (padded to 64 with pad tokens that never write) and 128 (two
    chunks): output and new state."""
    jcfg, tcfg = _cfgs("xlstm-350m", dtype)
    jp, tp = _block_params(JXL.init_mlstm, 6, jcfg)
    rng = np.random.default_rng(s)
    hh, dh = jcfg.n_heads, 2 * jcfg.d_model // jcfg.n_heads
    x = (rng.standard_normal((2, s, jcfg.d_model)) * 0.5).astype(np.float32)
    state = (rng.standard_normal((2, hh, dh, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((2, hh, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((2, hh)).astype(np.float32))
    jdt = jnp.dtype(dtype)
    want, wc = _jax_run(dtype, JXL.mlstm_block, jp, jcfg,
                        jnp.asarray(x, jdt), cache=JXL.MlstmCache(
                            *map(jnp.asarray, state)))
    got, gc = TXL.mlstm_block(tp, tcfg,
                              torch.as_tensor(x).to(getattr(torch, dtype)),
                              cache=TXL.MlstmCache(
                                  *map(torch.as_tensor, state)))
    assert got.shape == (2, s, jcfg.d_model)
    _close(got, want, dtype)
    for f in ("c", "n", "m"):
        _close(getattr(gc, f), getattr(wc, f), dtype)


def test_mlstm_pad_tokens_never_write():
    """A 50-token prompt's state equals the state after the same 50
    tokens run one at a time: the 14 pad tokens added no memory."""
    jcfg, tcfg = _cfgs("xlstm-350m", "float32")
    _, tp = _block_params(JXL.init_mlstm, 4, jcfg)
    x = torch.randn(1, 50, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(1)) * 0.5
    _, whole = TXL.mlstm_block(tp, tcfg, x, cache=TXL.init_mlstm_cache(
        tcfg, 1))
    step = TXL.init_mlstm_cache(tcfg, 1)
    for t in range(50):
        _, step = TXL.mlstm_block(tp, tcfg, x[:, t:t + 1], cache=step)
    for f in ("c", "n", "m"):
        torch.testing.assert_close(getattr(whole, f), getattr(step, f),
                                   rtol=1e-4, atol=1e-5)


def test_mlstm_scale_rounds_to_bfloat16():
    """q and k are scaled by dh^-0.5 rounded to the compute dtype first,
    as JAX's weakly typed scalar is: in bfloat16 the block equals JAX's
    op-by-op run on the same inputs to the last few ulps, which the
    unrounded float32 scale would not give."""
    jcfg, tcfg = _cfgs("xlstm-350m", "bfloat16")
    jp, tp = _block_params(JXL.init_mlstm, 9, jcfg)
    x = np.random.default_rng(2).standard_normal(
        (1, 64, jcfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        want, _ = JXL.mlstm_block(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    got, _ = TXL.mlstm_block(tp, tcfg, torch.as_tensor(x).bfloat16())
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=2 ** -7, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 33])
def test_slstm_block_matches_jax(s, dtype):
    """The sLSTM (head-major recurrent layout, gates as contiguous
    quarters) from a non-zero cache: output and (h, c, n, m)."""
    jcfg, tcfg = _cfgs("xlstm-350m", dtype)
    jp, tp = _block_params(JXL.init_slstm, 7, jcfg)
    rng = np.random.default_rng(s)
    d = jcfg.d_model
    x = (rng.standard_normal((2, s, d)) * 0.5).astype(np.float32)
    st = [rng.standard_normal((2, d)).astype(np.float32) * 0.3
          for _ in range(4)]
    st[2] = np.abs(st[2]) + 1.0                       # a normalizer
    jdt = jnp.dtype(dtype)
    want, wc = _jax_run(dtype, JXL.slstm_block, jp, jcfg,
                        jnp.asarray(x, jdt),
                        cache=JXL.SlstmCache(*map(jnp.asarray, st)))
    got, gc = TXL.slstm_block(tp, tcfg,
                              torch.as_tensor(x).to(getattr(torch, dtype)),
                              cache=TXL.SlstmCache(*map(torch.as_tensor,
                                                        st)))
    _close(got, want, dtype)
    for f in ("h", "c", "n", "m"):
        _close(getattr(gc, f), getattr(wc, f), dtype)


def test_slstm_recurrent_layout_is_head_major():
    """r_h's (H, Dh, 4 Dh) product is flattened head-major and the gates
    are contiguous D-wide quarters of that: a per-gate-per-head split
    gives a different cell, which JAX's does not match."""
    jcfg, tcfg = _cfgs("xlstm-350m", "float32")
    jp, tp = _block_params(JXL.init_slstm, 11, jcfg)
    d, hh = jcfg.d_model, jcfg.n_heads
    rng = np.random.default_rng(3)
    xg = rng.standard_normal((2, 4 * d)).astype(np.float32)
    st = [rng.standard_normal((2, d)).astype(np.float32) for _ in range(4)]
    want = JXL._slstm_cell(jp, jcfg, jnp.asarray(xg),
                           tuple(map(jnp.asarray, st)))
    got = TXL._slstm_cell(tp, tcfg, torch.as_tensor(xg),
                          tuple(map(torch.as_tensor, st)))
    for g, w in zip(got, want):
        _close(g, w, "float32")
    # the other layout: (B, H, 4, Dh) -> gate-major
    rec = torch.einsum("bhd,hdk->bhk", torch.as_tensor(st[0]).reshape(
        2, hh, d // hh), tp["r_h"])
    other = rec.reshape(2, hh, 4, d // hh).transpose(1, 2).reshape(2, 4 * d)
    assert not torch.allclose(other, rec.reshape(2, 4 * d))


# ----------------------------------------------------------------------
# Cache trees and the KV transfer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT + ["gemma2-9b"])
def test_cache_tree_layout_matches_jax(arch):
    """``init_caches`` node by node against JAX's (groups, then tail):
    the node type, each field's shape and dtype, and zeros / -1 pos;
    ``leaves()`` holds only the K and V tensors, in JAX's order;
    ``layer(i)`` is a view; ``clone()`` copies every node."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jc = JM.init_caches(jcfg, 2, 40)
    tc = TM.init_caches(tcfg, 2, 40)
    jnodes = [v for n in list(jc["groups"]) + list(jc["tail"])
              for v in n.values()]
    assert len(tc.nodes()) == len(jnodes)
    kv = []
    for got, want in zip(tc.nodes(), jnodes):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
            assert tuple(g.shape) == w.shape and str(g.dtype) == (
                f"torch.{w.dtype}"), (f.name, g.shape, w.shape)
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))
        if isinstance(want, JL.AttnCache):
            kv += [want.k.shape, want.v.shape]
    assert [tuple(t.shape) for t in tc.leaves()] == kv
    n_groups, tail = tcfg.pattern_layout()
    plen = len(tcfg.block_pattern)
    for i in range(tcfg.n_layers):
        node = tc.layer(i)
        kind = (tcfg.block_pattern[i % plen] if i < n_groups * plen
                else tail[i - n_groups * plen])
        want_type = {"rglru": "RglruCache", "mlstm": "MlstmCache",
                     "slstm": "SlstmCache"}.get(kind, "AttnCache")
        assert type(node).__name__ == want_type
        if i < n_groups * plen:
            stacked = tc.groups[i % plen].tensors()[0]
            assert node.tensors()[0].data_ptr() == stacked[i // plen
                                                           ].data_ptr()
    copy = tc.clone()
    for a, b in zip(copy.nodes(), tc.nodes()):
        for x, y in zip(a.tensors(), b.tensors()):
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


def _recurrent_caches(arch, dtype, plen=40):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, plen))
    _, jc = JS.make_prefill(jcfg, plen + 8)(jp, {"tokens": jnp.asarray(
        prompt)})
    _, tc = TS.make_prefill(tcfg, plen + 8)(tp, torch.as_tensor(prompt))
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("coded", [True, False])
def test_degrade_caches_matches_jax_on_recurrentgemma(dtype, coded):
    """recurrentgemma's tree: its local layers' two K/V leaves shipped as
    JAX ships them (JAX's signs carried across), the RG-LRU state copied
    bit for bit into new storage, kv_position_error against JAX's."""
    jc, tc = _recurrent_caches("recurrentgemma-9b", dtype)
    assert len(tc.leaves()) == 2
    mask = jcoupling.kv_hole_masks(np.array([0.9]), N_ROT, seed=1)[0]
    key = jax.random.PRNGKey(42)
    signs = [torch.as_tensor(np.array(jcoding.rademacher(
        key, jcoding.plan(int(t.numel()), n_rot=N_ROT)))) for t in tc.leaves()]
    jdeg = JS.degrade_caches(jc, jnp.asarray(mask), key, coded=coded)
    tdeg = TS.degrade_caches(tc, torch.as_tensor(mask), coded=coded,
                             signs=signs)
    tol = dict(rtol=0.0, atol=1e-5) if dtype == "float32" else TOL[dtype]
    jnodes = [v for n in list(jdeg["groups"]) + list(jdeg["tail"])
              for v in n.values()]
    for got, want, clean in zip(tdeg.nodes(), jnodes, tc.nodes()):
        assert type(got) is type(clean)
        if isinstance(got, TL.AttnCache):
            for f in ("k", "v"):
                g = getattr(got, f)
                assert g.dtype == getattr(clean, f).dtype
                np.testing.assert_allclose(g.float().numpy(),
                                           _np(getattr(want, f)), **tol)
            assert torch.equal(got.pos, clean.pos)
        else:
            for g, c in zip(got.tensors(), clean.tensors()):
                assert torch.equal(g, c) and g.data_ptr() != c.data_ptr()
    if not coded:        # the uncoded holes are whole cache positions
        assert any(not torch.equal(a, b) for a, b in zip(tdeg.leaves(),
                                                         tc.leaves()))
    want_err = JS.kv_position_error(jc, jdeg, 40)
    got_err = TS.kv_position_error(tc, tdeg, 40)
    np.testing.assert_allclose(got_err.numpy(), _np(want_err),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-4,
                               atol=1e-4)


def test_degrade_caches_leaves_xlstm_unchanged():
    """xLSTM has no K/V leaf: degrade_caches draws and launches nothing
    and returns a copy equal bit for bit (JAX's tree_map returns the
    tree as it was); kv_position_error is zeros, as JAX's."""
    jc, tc = _recurrent_caches("xlstm-350m", "bfloat16", plen=20)
    assert tc.leaves() == []
    tfwht.launches = tunbias.launches = 0
    g = torch.Generator().manual_seed(2)
    before = g.get_state()
    deg = TS.degrade_caches(tc, torch.zeros(N_ROT, dtype=torch.bool), g)
    assert torch.equal(g.get_state(), before)
    assert tfwht.launches == 0 and tunbias.launches == 0
    for a, b in zip(deg.nodes(), tc.nodes()):
        for x, y in zip(a.tensors(), b.tensors()):
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    jdeg = JS.degrade_caches(jc, jnp.zeros(N_ROT), jax.random.PRNGKey(0))
    want = np.asarray(JS.kv_position_error(jc, jdeg, 20))
    got = TS.kv_position_error(tc, deg, 20)
    assert got.shape == (20,) and not got.any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_recurrent_decode_matches_teacher_forced_forward():
    """chip_smoke's long recurrentgemma check at smoke size, float32:
    decoding past the local layers' 64-slot ring with the RG-LRU state
    carried, the last step's logits against ``head(hidden(...))`` of a
    forward over the same tokens padded with filler (causal layers keep
    it out), unembedded at that position only."""
    cfg = dataclasses.replace(TC.get_smoke("recurrentgemma-9b"),
                              dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    plen, gen = 96, 8
    prompt = torch.randint(0, cfg.vocab_size, (1, plen),
                           generator=torch.Generator().manual_seed(1))
    logits, caches = TS.make_prefill(cfg, plen + gen)(params, prompt)
    assert caches.leaves()[0].shape[2] == cfg.window_size < plen
    toks = TS.greedy_decode(cfg, params, caches, torch.argmax(logits, -1)[
        :, None], plen, gen)
    last = plen + gen - 1
    got, _ = TS.make_decode(cfg)(params, caches, toks[:, -1:], last)
    seq = torch.nn.functional.pad(torch.cat([prompt, toks], 1), (0, 24))
    want = TM.head(params, cfg, TM.hidden(params, cfg, seq)[:, last:last + 1])
    torch.testing.assert_close(got, want[:, 0], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_launcher_smoke_on_cpu(arch, capsys):
    tfwht.launches = tunbias.launches = 0
    out = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "80", "--gen", "4",
                        "--kv-frac", "0.9"])
    assert out.shape == (2, 4)
    printed = capsys.readouterr().out
    if arch == "xlstm-350m":
        assert "no K/V cache to ship" in printed
    else:
        assert "wire rows lost, coded" in printed
    assert tfwht.launches == 0 and tunbias.launches == 0


def test_params_from_jax_carries_the_recurrent_blocks():
    """recurrentgemma's 5 smoke layers (one (rglru, rglru, local) group,
    then a two-layer rglru tail) and xLSTM's 4: every leaf across with
    its JAX dtype (``lam``, the gate vectors, ``w_if``, ``b_if``, ``b``
    and ``r_h`` float32), the same names and shapes as ``init_params``."""
    for arch, tail in (("recurrentgemma-9b", 2), ("xlstm-350m", 0)):
        jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
        assert len(jp["decoder"]["tail"]) == tail
        ours = TM.init_params(tcfg, torch.Generator().manual_seed(0))
        assert ours.keys() == tp.keys()
        for k in ours:
            assert (ours[k].shape, ours[k].dtype) == (tp[k].shape,
                                                      tp[k].dtype), k
    np.testing.assert_array_equal(
        tp["layers.3.slstm.r_h"].numpy(),
        np.asarray(jp["decoder"]["groups"][3]["slstm"]["r_h"][0]))
    assert tp["layers.0.mlstm.b_if"].dtype == torch.float32
    jp = JM.init_params(jax.random.PRNGKey(0),
                        JC.get_smoke("recurrentgemma-9b"))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    np.testing.assert_array_equal(
        tp["layers.4.rglru.lam"].numpy(),
        np.asarray(jp["decoder"]["tail"][1]["rglru"]["lam"]))
    assert "layers.2.attn.wq" in tp and "layers.4.mlp.wg" in tp


@pytest.mark.parametrize("arch", RECURRENT)
def test_configs_match_jax_field_for_field(arch):
    """CONFIG and SMOKE equal the JAX package's in every field the port
    has, ``is_subquadratic`` included."""
    for name in ("get", "get_smoke"):
        tcfg, jcfg = getattr(TC, name)(arch), getattr(JC, name)(arch)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert tcfg.is_subquadratic and jcfg.is_subquadratic
    assert not TC.get("gemma2-9b").is_subquadratic


def test_init_params_lam_in_the_decay_range():
    """``lam`` is drawn so that a^c lies in [0.9, 0.999] (Griffin's
    stable-decay init): exp(-8 softplus(lam)) in [0.81, 0.998]."""
    cfg = TC.get_smoke("recurrentgemma-9b")
    p = TM.init_params(cfg, torch.Generator().manual_seed(5))
    lam = p["layers.0.rglru.lam"]
    decay = torch.exp(-8 * torch.nn.functional.softplus(lam))
    assert lam.dtype == torch.float32
    assert decay.min() >= 0.9 ** 2 - 1e-6 and decay.max() <= 0.999 ** 2 + 1e-6
    assert not torch.equal(lam, p["layers.1.rglru.lam"])
