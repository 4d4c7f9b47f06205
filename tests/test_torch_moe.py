"""The port's MoE family (qwen2-moe-a2.7b, granite-moe-3b-a800m) against
the JAX package's, at smoke size on the CPU.

The JAX weights are carried across (``params_from_jax``), and the inputs
are made from numpy seeds.  Tolerances are ``tests/test_torch_families
.py``'s: float32 rtol/atol 2e-4; bfloat16 atol 6.25e-2 plus rtol 2^-6.
Every comparison of a block, a forward or a decode first asserts that
both sides routed every token to the same experts (a top-k boundary
within one ulp could flip between the frameworks; a flip must show as a
flip, not as a tolerance failure).  The JAX side runs op by op
(``jax.disable_jit``), as the port runs eagerly: under ``jit`` XLA's
fusions round bfloat16 intermediates differently.

The train step on one device is held to ``tests/test_torch_train.py``'s
tolerances (loss rtol 1e-5, first moments atol 1e-8, the first AdamW
update to its conditioning bound); the expert-parallel cases, on four
gloo ranks beside a JAX subprocess with four host devices, in
:func:`ep_runs`.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint import checkpoint as jckpt
from repro.core import coding as jcoding
from repro.core.transport import coupling as jcoupling
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.optim import adamw as jadamw
from repro.serve import serve_step as JS
from repro.train import sharding_rules as jrules
from repro.train import train_step as jts
import repro_torch.configs as TC
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import serve_step as TS
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer
from test_torch_dp_train import _draws, _free_port, fake_world

ARCHS = ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2 ** -6, atol=6.25e-2)}
B, PLEN, GEN = 2, 16, 6
MIN_CODED, DROP = 1024, 0.1
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=500)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a, np.float32)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def _cfgs(arch, dtype="float32", **moe_kw):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype=dtype)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe_kw))
    return jcfg, tcfg


@functools.cache
def _pair(arch, dtype="float32"):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.params_from_jax(jax.tree.map(np.asarray,
                                                                jp))


def _moe_params(arch, dtype):
    """One layer's JAX ``init_moe`` tree and the port's flat leaves."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = JMOE.init_moe(jax.random.PRNGKey(3), jcfg)
    flat = dict(convert._flatten(jax.tree.map(np.asarray, jp)))
    return jcfg, tcfg, jp, {k: convert._tensor(v) for k, v in flat.items()}


@pytest.fixture
def routes(monkeypatch):
    """Both sides' routing ids, one (G, k) array a ``_route`` call, in
    call order (one call an MoE layer a forward)."""
    got = {"jax": [], "torch": []}
    jroute, troute = JMOE._route, TMOE._route

    def jrec(*a, **k):
        out = jroute(*a, **k)
        got["jax"].append(np.asarray(out[1]))
        return out

    def trec(*a, **k):
        out = troute(*a, **k)
        got["torch"].append(out[1].numpy())
        return out

    monkeypatch.setattr(JMOE, "_route", jrec)
    monkeypatch.setattr(TMOE, "_route", trec)
    return got


def _same_routes(routes):
    assert routes["jax"] and len(routes["jax"]) == len(routes["torch"])
    for i, (j, t) in enumerate(zip(routes["jax"], routes["torch"])):
        np.testing.assert_array_equal(t, j, err_msg=f"routing call {i}")
    routes["jax"].clear()
    routes["torch"].clear()


# ----------------------------------------------------------------------
# The block's pieces
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["qwen2-moe-full", "granite-full"])
def test_padding_and_capacity_match_jax(arch):
    if arch.endswith("full"):
        name = ARCHS[0] if arch.startswith("qwen2") else ARCHS[1]
        jcfg, tcfg = JC.get(name), TC.get(name)
    else:
        jcfg, tcfg = _cfgs(arch)
    assert TMOE.padded_experts(tcfg) == JMOE.padded_experts(jcfg)
    for g in (1, 7, 48, 1000, 4096, 8 * 128 // 4):
        for tp in (1, 2, 4):
            assert TMOE._capacity(tcfg, g, tp) == JMOE._capacity(jcfg, g, tp)
    assert TMOE.param_specs(tcfg).keys() == {
        n for n, _ in convert._flatten(JMOE.param_specs(jcfg))}
    if arch == "qwen2-moe-full":
        assert TMOE.padded_experts(tcfg) == 64
        assert TMOE._capacity(tcfg, 4096, 1) == 320


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _moe_params(arch, dtype)
    x = np.random.default_rng(0).standard_normal((48, jcfg.d_model))
    e = JMOE.padded_experts(jcfg)
    jtop, jids, jaux = JMOE._route(jp, jcfg, jnp.asarray(x, dtype), e)
    ttop, tids, taux = TMOE._route(tp["router"], tcfg, torch.as_tensor(
        x).to(getattr(torch, dtype)), e)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tids.max()) < tcfg.moe.n_experts      # padding never picked
    np.testing.assert_allclose(ttop.numpy(), _np(jtop), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("g,k,e,real,cap", [
    (40, 2, 16, 12, 4), (40, 2, 16, 12, 8), (40, 2, 16, 12, 40),
    (4096, 4, 64, 60, 320)])    # the last: qwen2-moe's 8 x 512 prefill
def test_dispatch_indices_match_jax(g, k, e, real, cap):
    ids = np.random.default_rng(cap).integers(0, real, (g, k))
    want = JMOE._dispatch_indices(jnp.asarray(ids), e, cap)
    got = TMOE._dispatch_indices(torch.as_tensor(ids), e, cap)
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert bool((~got[2]).any()) == (cap < 40)


@pytest.mark.parametrize("capacity", ["overflow", "roomy"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_local_matches_jax(arch, dtype, capacity, routes):
    """``moe_block`` on one device: qwen2-moe with its shared expert,
    granite without; at the configs' capacity factor (1.25: picks
    overflow and drop) and at 50 (none drop)."""
    jcfg, tcfg, jp, tp = _moe_params(arch, dtype)
    if capacity == "roomy":
        jcfg, tcfg = _cfgs(arch, dtype, capacity_factor=50.0)
    x = np.random.default_rng(1).standard_normal((2, 24, jcfg.d_model)) * 0.5
    TMOE.drop_log = []
    try:
        with jax.disable_jit():
            want, jaux = JMOE.moe_block(jp, jcfg, jnp.asarray(x, dtype))
        got, taux = TMOE.moe_block(tp, tcfg,
                                   torch.as_tensor(x).to(getattr(torch,
                                                                 dtype)))
        dropped = int(sum(TMOE.drop_log))
    finally:
        TMOE.drop_log = None
    _same_routes(routes)
    assert (dropped > 0) == (capacity == "overflow")
    assert ("shared.wi" in tp) == (arch == ARCHS[0])
    assert got.shape == x.shape and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


# ----------------------------------------------------------------------
# Weights, the leaf view, the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_layout(arch):
    jcfg, tcfg, jp, tp = _pair(arch, "bfloat16")
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert ours.keys() == tp.keys()
    for k in ours:
        assert (ours[k].shape, ours[k].dtype) == (tp[k].shape, tp[k].dtype), k
    moe = jp["decoder"]["groups"][0]["moe"]
    for i in range(tcfg.n_layers):
        for name in ("wi", "wg", "wo", "router"):
            np.testing.assert_array_equal(
                tp[f"layers.{i}.moe.{name}"].float().numpy(),
                _np(moe[name][i]))
        if "shared" in moe:
            np.testing.assert_array_equal(
                tp[f"layers.{i}.moe.shared.wo"].float().numpy(),
                _np(moe["shared"]["wo"][i]))
    assert tp["layers.0.moe.router"].dtype == torch.float32
    assert tp["layers.0.moe.wi"].shape == (16, 128, tcfg.moe.d_expert)


def test_init_draws_with_jaxs_fan_in():
    """The expert weights' std follows JAX's fan-in (d for wi, the expert
    width for wo), not their leading dim E."""
    cfg = TC.get_smoke(ARCHS[1])
    p = TM.init_params(cfg, torch.Generator().manual_seed(3))
    for name, fan in (("wi", cfg.d_model), ("wo", cfg.moe.d_expert),
                      ("router", cfg.d_model)):
        w = p[f"layers.0.moe.{name}"].float()
        assert torch.all(w.abs() <= 2 * fan ** -0.5 * 1.01), name
        assert 0.7 * fan ** -0.5 < w.std() < fan ** -0.5, name


def test_leaf_view_is_tree_flatten_order():
    jcfg, tcfg, jp, tp = _pair(ARCHS[0], "float32")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = ["".join(f".{e.key}" if hasattr(e, "key") else f"[{e.idx}]"
                     for e in path)[1:] for path, _ in flat]
    assert len(flat) == 18
    assert names == list(convert.leaf_names(tcfg))
    assert [tuple(x.shape) for _, x in flat] == convert.leaf_shapes(tcfg)
    assert convert.leaf_shapes(TC.get(ARCHS[0])) == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jax.eval_shape(
            lambda k: JM.init_params(k, JC.get(ARCHS[0])),
            jax.random.PRNGKey(0)))]
    leaves = convert.jax_leaves(tp, tcfg)
    for got, (_, want) in zip(leaves, flat):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    back = convert.params_from_leaves(leaves, tcfg)
    assert back.keys() == tp.keys()
    assert all(torch.equal(back[k], tp[k]) for k in tp)
    # qwen2's view: one group's 12 leaves, then the table and final norm
    q = TC.get_smoke("qwen2-0.5b")
    layer = ("attn.bk", "attn.bq", "attn.bv", "attn.wk", "attn.wo",
             "attn.wq", "attn.wv", "ln1.scale", "ln2.scale", "mlp.wg",
             "mlp.wi", "mlp.wo")
    top = ("embed.table", "final_norm.scale")
    assert convert.leaf_names(q) == tuple(
        f"decoder.groups[0].{n}" for n in layer) + top
    assert convert.short_names(q) == layer + top


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
def test_plans_and_specs_match_jax(mesh):
    """The coded sync's plans and the partition specs of the 18 leaves at
    full width, against JAX's on the same mesh shape (the MoE expert
    leaves tile around E, ``sharded_dim`` 1)."""
    import types
    from repro_torch.launch import mesh as tmesh
    from repro_torch.train import sharding_rules as trules
    jcfg, tcfg = JC.get(ARCHS[0]), TC.get(ARCHS[0])
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    stub = types.SimpleNamespace(shape={"data": mesh[0], "model": mesh[1]})
    jspecs = [tuple(s) for s in jax.tree_util.tree_leaves(
        jrules.param_specs(shapes, stub),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    celeris = tts.CelerisConfig(mode="lossy_hadamard")
    with fake_world(4):
        m = tmesh.make_host_mesh(mesh, device_type="cpu")
        names = convert.leaf_names(tcfg)
        tspecs = trules.param_specs(convert.leaf_shapes(tcfg), m, names)
        plans = tts.plan_leaves(convert.leaf_shapes(tcfg), m, celeris, names)
    assert [tuple(s) + (None,) * (len(sh.shape) - len(s))
            for s, sh in zip(jspecs, jax.tree_util.tree_leaves(shapes))] == [
        s + (None,) * (len(sh.shape) - len(s))
        for s, sh in zip(tspecs, jax.tree_util.tree_leaves(shapes))]
    for leaf, spec, plan in zip(jax.tree_util.tree_leaves(shapes), jspecs,
                                plans):
        sd = next((i for i, a in enumerate(spec) if a == "model"), None)
        want = (jcoding.plan_nd(leaf.shape, sd, 4096)
                if leaf.size >= celeris.min_coded_size else None)
        assert (plan is None) == (want is None)
        if plan is not None:
            assert (plan.tiles, plan.n_rot, plan.sharded_dim) == (
                want.tiles, want.n_rot, want.sharded_dim)
    assert plans[names.index("decoder.groups[0].moe.wi")].sharded_dim == 1


def _jax_nodes(jc):
    return [n["attn"] for n in list(jc["groups"]) + list(jc["tail"])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, dtype, routes):
    """The forward's logits and aux, then prefill and decode steps (every
    cache leaf), against JAX's; the tokens fed are JAX's argmax."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, PLEN))
    with jax.disable_jit():
        want, _, jaux = JM.forward(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                   remat=False)
    x, taux = TM.hidden_aux(tp, tcfg, torch.as_tensor(prompt))
    _same_routes(routes)
    _close(TM.head(tp, tcfg, x), want, dtype)
    # bfloat16: the aux reads the rounded residual stream of each layer
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 2 ** -6)
    with jax.disable_jit():
        jl, jc = JS.make_prefill(jcfg, PLEN + GEN)(
            jp, {"tokens": jnp.asarray(prompt)})
        tl, tc = TS.make_prefill(tcfg, PLEN + GEN)(tp, torch.as_tensor(
            prompt))
        _same_routes(routes)
        _close(tl, jl, dtype)
        jdec, tdec = JS.make_decode(jcfg), TS.make_decode(tcfg)
        for idx in range(PLEN, PLEN + GEN):
            tok = np.array(jnp.argmax(jl, -1))[:, None]
            jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok)},
                          jnp.int32(idx))
            tl, tc = tdec(tp, tc, torch.as_tensor(tok), idx)
            _same_routes(routes)
            _close(tl, jl, dtype)
    nodes = _jax_nodes(jc)
    assert len(tc.nodes()) == len(nodes) == 1
    for got, w in zip(tc.nodes(), nodes):
        _close(got.k, w.k, dtype)
        _close(got.v, w.v, dtype)
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(w.pos))


def test_degrade_caches_match_jax():
    """The coded KV transfer on a qwen2-moe cache: one payload a K/V
    leaf, against JAX's ``degrade_caches`` with the same signs."""
    jcfg, tcfg, jp, tp = _pair(ARCHS[0], "float32")
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, PLEN))
    _, jc = JS.make_prefill(jcfg, PLEN + GEN)(jp,
                                              {"tokens": jnp.asarray(prompt)})
    _, tc = TS.make_prefill(tcfg, PLEN + GEN)(tp, torch.as_tensor(prompt))
    mask = jcoupling.kv_hole_masks(np.array([0.9]), 64, seed=1)[0]
    leaves = jax.tree_util.tree_leaves(
        [{"k": n.k, "v": n.v} for n in _jax_nodes(jc)])
    key = jax.random.PRNGKey(2)
    signs = jcoding.rademacher(key, jcoding.plan(leaves[0].size, 64))
    want = JS.degrade_caches(jc, jnp.asarray(mask), key)
    got = TS.degrade_caches(tc, torch.as_tensor(mask),
                            signs=torch.as_tensor(np.asarray(signs)))
    for g, w in zip(got.nodes(), _jax_nodes(want)):
        np.testing.assert_allclose(g.k.numpy(), _np(w.k), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.v.numpy(), _np(w.v), rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------------------------
# Training on one device
# ----------------------------------------------------------------------

@functools.cache
def _batch():
    from repro.data import pipeline as jpipe
    src = jpipe.make_source(jpipe.DataConfig(vocab_size=512, seq_len=32,
                                             global_batch=4, seed=1))
    return src.global_batch(0)


def _tbatch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}


@functools.cache
def _jax_step(mode):
    jcfg, _, jparams, _ = _pair(ARCHS[0], "float32")
    celeris = jts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED,
                                lossy_moe=True)
    step = jts.make_train_step(jcfg, None, jadamw.OptConfig(**OPT), celeris,
                               donate=False)
    state = {"params": jparams, "opt": jadamw.init_opt_state(jparams),
             "step": jnp.zeros((), jnp.int32)}
    key = jax.random.PRNGKey(5)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                _batch().items()}, key, jnp.float32(DROP))
    (loss, (nll, aux)), grads = jax.value_and_grad(
        lambda p: JM.lm_loss(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in _batch().items()}),
        has_aux=True)(jparams)
    masks, signs = {}, {}
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jparams)):
        if leaf.size < MIN_CODED:
            continue
        plan = jcoding.plan_nd(leaf.shape, None, celeris.n_rot)
        masks[i] = torch.as_tensor(np.array(
            jts._leaf_mask(key, i, 0, plan.n_rot, jnp.float32(DROP))))
        signs[i] = torch.as_tensor(np.array(jcoding.rademacher_nd(
            jax.random.fold_in(key, 2 * i), plan)))
    return (jax.tree.map(np.asarray, new),
            {k: float(v) for k, v in metrics.items()}, masks, signs,
            (float(loss), float(nll), float(aux),
             [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]))


def test_lm_loss_and_grads_match_jax():
    _, tcfg, _, tp = _pair(ARCHS[0], "float32")
    *_, (jloss, jnll, jaux, jgrads) = _jax_step("exact")
    loss, nll, aux, grads = tts.loss_and_grads(
        tcfg, convert.jax_leaves(tp, tcfg),
        _tbatch(_batch()))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(nll), jnll, rtol=1e-5)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5)
    assert float(aux) > 0
    assert len(grads) == len(jgrads) == 18
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def check_step(new, m, jnew, jm):
    """``tests/test_torch_train.py``'s tolerances for one whole step."""
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), jm["aux"], rtol=1e-5)
    assert float(m["recv_frac"]) == pytest.approx(jm["recv_frac"], abs=1e-7)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-5)
    eps, lr, b1 = 1e-8, OPT["lr"], 0.9
    jleaves = jax.tree_util.tree_leaves(jnew["params"])
    jmu = jax.tree_util.tree_leaves(jnew["opt"]["mu"])
    assert len(new["params"]) == len(jleaves) == 18
    for got, want, mu, want_mu in zip(new["params"], jleaves,
                                      new["opt"]["mu"], jmu):
        np.testing.assert_allclose(mu.numpy(), want_mu, atol=1e-8)
        g = np.abs(want_mu) / (1 - b1)
        dg = np.abs(mu.numpy() - want_mu) / (1 - b1)
        bound = 1e-7 + 2 * lr * eps * dg / (g + eps) ** 2
        assert np.all(np.abs(got.numpy() - want) <= bound)


@pytest.mark.parametrize("mode", ["exact", "lossy_hadamard"])
def test_train_step_matches_jax(mode):
    """One step of qwen2-moe on one device with ``lossy_moe`` on (inert
    there, as in JAX): loss, nll, aux, the synced gradients (first
    moments) and the first AdamW update; in ``lossy_hadamard`` the MoE
    leaves are coded at their JAX leaf indices with JAX's draws."""
    _, tcfg, _, tp = _pair(ARCHS[0], "float32")
    jnew, jm, masks, signs, _ = _jax_step(mode)
    leaves = convert.jax_leaves(tp, tcfg)
    step = tts.make_train_step(
        tcfg, None, tadamw.OptConfig(**OPT),
        tts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED,
                          lossy_moe=True))
    new, m = step(tts.state_from_params(leaves, tcfg), _tbatch(_batch()),
                  None, DROP, masks=masks, signs=signs)
    names = convert.leaf_names(tcfg)
    assert {names[i] for i in masks} >= {
        f"decoder.groups[0].moe.{n}" for n in ("wi", "wg", "wo",
                                               "shared.wi")}
    if mode != "exact":
        assert float(m["recv_frac"]) < 1.0
    check_step(new, m, jnew, jm)


def test_refusals():
    """granite-moe trains (no shared experts, no QKV bias: held to JAX's
    steps in ``tests/test_torch_train_families.py``): its step, state and
    Trainer build and one CPU step runs.  Microbatches in an MoE step on
    dp ranks outside the lossy island (where JAX routes the global
    batch) are refused; that step itself builds."""
    cfg = TC.get_smoke(ARCHS[1])
    tts.make_train_step(cfg)
    state = tts.init_state(torch.Generator(), cfg)
    assert len(state["params"]) == len(convert.leaf_names(cfg)) == 12
    tr = Trainer(cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=2),
                 device="cpu")
    hist = tr.run(1)
    assert np.isfinite(hist["loss"]).all() and int(tr.state["step"]) == 1
    from repro_torch.launch import mesh as tmesh
    q = TC.get_smoke(ARCHS[0])
    with fake_world(4):
        m = tmesh.make_host_mesh((2, 2), device_type="cpu")
        assert tts.make_train_step(q, m).model_group.size == 2
        with pytest.raises(NotImplementedError, match="global batch"):
            tts.make_train_step(q, m, microbatches=2)
        assert tts.make_train_step(q, m, None, tts.CelerisConfig(
            mode="lossy_hadamard", lossy_moe=True)).model_group.size == 2
        # a data axis of 1 runs exact on the model axis
        m14 = tmesh.make_host_mesh((1, 4), device_type="cpu")
        assert tts.make_train_step(q, m14).model_group.size == 4


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A qwen2-moe smoke state saved by the port restores in the JAX
    package, bit for bit, and JAX's in the port (the 18 leaves under
    JAX's ``keystr`` names)."""
    jcfg, tcfg = _cfgs(ARCHS[0], "bfloat16")
    jstate = jts.init_state(jax.random.PRNGKey(4), jcfg)
    names = convert.leaf_names(tcfg)
    tstate = tts.state_from_params(convert.jax_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jstate["params"])), tcfg), tcfg)
    tckpt.save(str(tmp_path / "port"), 3, tts.state_leaves(tstate, names),
               {"arch": tcfg.name})
    got, step, _ = jckpt.restore(str(tmp_path / "port"), jstate)
    assert int(step) == 3
    tleaves = [x for _, x in tts.state_leaves(tstate, names)]
    jleaves = jax.tree_util.tree_leaves(got)
    assert len(jleaves) == len(tleaves) == 4 * 18 + 2
    for a, b in zip(jleaves, tleaves):
        assert np.asarray(a).shape == tuple(b.shape)
        np.testing.assert_array_equal(_np(a), b.float().numpy())
    jckpt.save(str(tmp_path / "jax"), 5, jstate)
    leaves, step, _ = tckpt.restore(str(tmp_path / "jax"),
                                    tts.state_leaves(tstate, names))
    assert int(step) == 5
    back = tts.state_from_leaves(leaves)
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    [x for _, x in tts.state_leaves(back, names)]):
        np.testing.assert_array_equal(_np(a), b.float().numpy())


# ----------------------------------------------------------------------
# The launchers
# ----------------------------------------------------------------------

def test_serve_launcher_moe_smoke_on_cpu(capsys):
    out = tserve.main(["--arch", ARCHS[0], "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "24", "--gen", "4",
                       "--kv-frac", "0.9"])
    assert out.shape == (2, 4)
    assert "wire rows lost, coded" in capsys.readouterr().out


def test_train_launcher_lossy_moe_on_cpu(capsys):
    hist = tlaunch.main(["--arch", ARCHS[0], "--smoke", "--device", "cpu",
                         "--celeris", "--lossy-moe", "--steps", "2",
                         "--seq-len", "32", "--global-batch", "2"])
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert all(0.0 < d for d in hist["drop_rate"])
    assert "step    1" in capsys.readouterr().out


# ----------------------------------------------------------------------
# Expert parallelism: four gloo ranks against JAX on four host devices
# ----------------------------------------------------------------------

WORLD, TIMEOUT = 4, 400
EP_MESHES = {"dm14": ((1, 4), ("data", "model")),
             "dm22": ((2, 2), ("data", "model"))}
EP_SEQ, EP_BATCH, EP_DROP, STEP_KEY = 32, 8, 0.3, 7
# name -> (mesh, mode, lossy_moe drop rate)
EP_STEPS = {"dm14_exact_moe": ("dm14", "exact", EP_DROP),
            "dm22_exact_moe": ("dm22", "exact", EP_DROP),
            "dm22_lh_moe": ("dm22", "lossy_hadamard", EP_DROP)}

EP_JAX = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro import sharding as shd
from repro.models import model as M, moe as MOE
from repro.optim import adamw
from repro.train import train_step as ts
d = sys.argv[1]
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
meshes = {k: shd.make_mesh(tuple(v[0]), tuple(v[1]))
          for k, v in meta["meshes"].items()}
cfg = dataclasses.replace(C.get_smoke("qwen2-moe-a2.7b"), dtype="float32")
roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=50.0))
p = MOE.init_moe(jax.random.PRNGKey(3), cfg)
x, r = jnp.asarray(inp["block_x"]), jnp.asarray(inp["block_r"])
out = {}

def block_loss(p_, x_, key, lossy):
    y, aux = MOE.moe_block(p_, cfg, x_, lossy=lossy, key=key,
                           drop_rate=meta["drop"])
    return jnp.sum(y * r) + aux, (y, aux)

for mk, mesh in meshes.items():
    shd.set_global_mesh(mesh)
    for lossy in (False, True):
        name = f"block_{mk}_{'lossy' if lossy else 'plain'}"
        (l, (y, aux)), g = jax.jit(jax.value_and_grad(
            lambda p_, x_: block_loss(p_, x_, jax.random.PRNGKey(11), lossy),
            argnums=(0, 1), has_aux=True))(p, x)
        out[name + "_y"], out[name + "_aux"] = np.asarray(y), np.asarray(aux)
        out[name + "_gx"] = np.asarray(g[1])
        for k, v in g[0].items():
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    out[f"{name}_g_{k}.{k2}"] = np.asarray(v2)
            else:
                out[f"{name}_g_{k}"] = np.asarray(v)
shd.set_global_mesh(None)
y, aux = MOE.moe_block(p, roomy, x)
out["roomy_local_y"], out["roomy_local_aux"] = np.asarray(y), np.asarray(aux)

params = M.init_params(jax.random.PRNGKey(0), cfg)
for name, (mk, mode, drop) in meta["steps"].items():
    mesh = meshes[mk]
    shd.set_global_mesh(mesh)
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           lossy_moe=True)
    step = ts.make_train_step(cfg, mesh, adamw.OptConfig(**meta["opt"]),
                              cel, donate=False)
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "step": jnp.zeros((), jnp.int32)}
    n = meta["n_dp"][name]
    batch = {k: jnp.asarray(inp[f"{k}_n{n}"]) for k in ("tokens", "labels")}
    new, m = step(state, batch, jax.random.PRNGKey(meta["step_key"]),
                  jnp.float32(drop))
    leaves = jax.tree_util.tree_leaves
    for i, (w, mu) in enumerate(zip(leaves(new["params"]),
                                    leaves(new["opt"]["mu"]))):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = (np.asarray(w),
                                                     np.asarray(mu))
    for k, v in m.items():
        out[f"{name}_m_{k}"] = np.asarray(v)
shd.set_global_mesh(None)
np.savez(d + "/jax.npz", **out)
"""

EP_TORCH = """
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        rank=rank, world_size=4)
torch.set_num_threads(1)
import repro_torch.configs as C
from repro_torch import sharding as shd
from repro_torch.models import convert, model as M, moe as MOE
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
t = lambda a: torch.as_tensor(np.array(a))
meshes = {k: shd.make_mesh(tuple(v[0]), tuple(v[1]), "cpu")
          for k, v in meta["meshes"].items()}
cfg = dataclasses.replace(C.get_smoke("qwen2-moe-a2.7b"), dtype="float32")
roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=50.0))
names = convert.leaf_names(cfg)
specs = MOE.param_specs(cfg)
whole = {k[len("moe_"):]: t(inp[k]) for k in inp.files
         if k.startswith("moe_")}
x, r = t(inp["block_x"]), t(inp["block_r"])
out = {}

def block(mesh, c, lossy, drop, grads=True):
    tp = convert.model_group(c, mesh)
    p = {k: shd.local_slice(v, specs[k], mesh).clone().requires_grad_()
         for k, v in whole.items()}
    xg = x.clone().requires_grad_()
    y, aux = MOE.moe_block(p, c, xg, tp=tp, lossy=lossy,
                           coins=t(inp["block_coins_" + str(tp.size)]),
                           drop_rate=drop)
    if not grads:
        return y.detach(), aux.detach(), None
    (torch.sum(y * r) + aux).backward()
    g = {k: v.grad for k, v in p.items()}
    g["x"] = xg.grad
    return y.detach(), aux.detach(), g

for mk, mesh in meshes.items():
    for lossy in (False, True):
        name = f"block_{mk}_{'lossy' if lossy else 'plain'}"
        y, aux, g = block(mesh, cfg, lossy, meta["drop"])
        out[name + "_y"], out[name + "_aux"] = y.numpy(), aux.numpy()
        for k, v in g.items():
            out[f"{name}_g_{k}"] = v.numpy()
    # lossy at drop 0 == off, bit for bit
    y0, a0, g0 = block(mesh, cfg, True, 0.0)
    y1, a1, g1 = block(mesh, cfg, False, 0.0)
    out[f"drop0_{mk}"] = np.bool_(torch.equal(y0, y1) and torch.equal(a0, a1)
                                  and all(torch.equal(g0[k], g1[k])
                                          for k in g0))
    # EP = local at capacity 50
    y, aux, _ = block(mesh, roomy, False, 0.0, grads=False)
    out[f"roomy_ep_{mk}_y"], out[f"roomy_ep_{mk}_aux"] = y.numpy(), aux.numpy()
y, aux = MOE.moe_block(whole, roomy, x)
out["roomy_local_y"] = y.detach().numpy()

# whole train steps
leaves = [t(inp[f"leaf{i}"]) for i in range(len(names))]
opt = adamw.OptConfig(**meta["opt"])
for name, (mk, mode, drop) in meta["steps"].items():
    mesh = meshes[mk]
    dp = shd.dp_axes(mesh)
    peer = shd.peer_index(mesh, dp)
    n = meta["n_dp"][name]
    rows = inp["tokens_n%d" % n].shape[0] // n
    batch = {k: t(inp[f"{k}_n{n}"][peer * rows:(peer + 1) * rows]).long()
             for k in ("tokens", "labels")}
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           lossy_moe=True)
    step = ts.make_train_step(cfg, mesh, opt, cel)
    coded = [int(k[len(name) + 5:]) for k in inp.files
             if k.startswith(name + "_mask")]
    masks = {i: t(inp[f"{name}_mask{i}"][peer]) for i in coded}
    signs = {i: t(inp[f"{name}_signs{i}"]) for i in coded}
    tp = step.model_group
    coins = [t(c) for c in inp["step_coins_%d" % tp.size]]
    state = ts.state_from_params(convert.shard_leaves(leaves, mesh, names),
                                 cfg, mesh)
    new, m = step(state, batch, None, drop, masks=masks, signs=signs,
                  coins=coins)
    gathered = list(convert.gather_state(   # over data, then model
        new["opt"]["mu"], ts.state_specs(convert.leaf_shapes(cfg), mesh,
                                         names)["opt"]["mu"], mesh))
    for i, (p_, mu) in enumerate(zip(new["params"], new["opt"]["mu"])):
        out[f"{name}_p{i}"] = p_.numpy()
    for i, mu in enumerate(gathered):
        out[f"{name}_wmu{i}"] = mu.numpy()
    for k, v in m.items():
        out[f"{name}_m_{k}"] = v.numpy()
np.savez(d + "/rank%d.npz" % rank, **out)
dist.destroy_process_group()
"""


def _ep_coords(mk):
    shape, axes = EP_MESHES[mk]
    return [dict(zip(axes, np.unravel_index(r, shape))) for r in range(WORLD)]


def _ep_split_dims(mk):
    import types
    jcfg, _ = _cfgs(ARCHS[0])
    shape, axes = EP_MESHES[mk]
    specs = jax.tree_util.tree_leaves(
        jrules.param_specs(JM.init_params(jax.random.PRNGKey(0), jcfg),
                           types.SimpleNamespace(shape=dict(zip(axes,
                                                                shape)))),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [next((j for j, s in enumerate(spec) if s == "model"), None)
            for spec in specs]


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """One launch of four gloo ranks and one JAX subprocess with four host
    devices: the MoE block (output, aux and every gradient) on (1, 4) and
    (2, 2) meshes, plain and lossy with JAX's coins carried across; EP
    against the local path at capacity 50; and one whole lossy-MoE step
    on (1, 4) and (2, 2) exact and (2, 2) ``lossy_hadamard`` with JAX's
    draws."""
    d = str(tmp_path_factory.mktemp("moe_ep"))
    rng = np.random.default_rng(0)
    jcfg, _ = _cfgs(ARCHS[0])
    inp = {}
    jp = JMOE.init_moe(jax.random.PRNGKey(3), jcfg)
    for k, v in convert._flatten(jax.tree.map(np.asarray, jp)):
        inp[f"moe_{k}"] = v
    inp["block_x"] = (rng.standard_normal((2, EP_SEQ, jcfg.d_model))
                      * 0.5).astype(np.float32)
    inp["block_r"] = rng.standard_normal((2, EP_SEQ, jcfg.d_model)).astype(
        np.float32)
    for tp in (2, 4):   # JAX's coins: the block's key, the step's layers
        inp[f"block_coins_{tp}"] = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(11), (tp, tp)))
        inp[f"step_coins_{tp}"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(0), i), (tp, tp)))
            for i in range(jcfg.n_layers)])
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jleaves = jax.tree_util.tree_leaves(jparams)
    for i, leaf in enumerate(jleaves):
        inp[f"leaf{i}"] = np.asarray(leaf)
    from repro.data import pipeline as jpipe
    src = jpipe.make_source(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=EP_SEQ, global_batch=EP_BATCH,
        seed=1))
    for n in (1, 2):
        for k, v in src.global_batch(0, n).items():
            inp[f"{k}_n{n}"] = v
    key = jax.random.PRNGKey(STEP_KEY)
    n_dp = {}
    for name, (mk, mode, drop) in EP_STEPS.items():
        n_dp[name] = EP_MESHES[mk][0][0]
        if mode == "exact":
            continue
        dims = _ep_split_dims(mk)
        for i, (leaf, sd) in enumerate(zip(jleaves, dims)):
            if leaf.size < MIN_CODED:
                continue
            plan = jcoding.plan_nd(leaf.shape, sd, 4096)
            rates = [jnp.float32(drop)] * n_dp[name]
            for k, v in _draws(key, i, plan, range(n_dp[name]), rates,
                               False).items():
                inp[f"{name}_{k}{i}"] = v
    meta = {"meshes": EP_MESHES, "steps": EP_STEPS, "drop": EP_DROP,
            "min_coded": MIN_CODED, "opt": OPT, "n_dp": n_dp,
            "step_key": STEP_KEY}
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(repo, "src"), repo]), OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(EP_JAX), d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    port = str(_free_port())
    procs += [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(EP_TORCH), str(r), port, d],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    failed = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT)
            if p.returncode != 0:
                failed.append(log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)
    jax_out = dict(np.load(os.path.join(d, "jax.npz")))
    return inp, jax_out, [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                          for r in range(WORLD)]


def _block_shard(want, key, mk, rank):
    """JAX's whole gradient of an MoE leaf cut to ``rank``'s shard."""
    _, tcfg = _cfgs(ARCHS[0])
    spec = TMOE.param_specs(tcfg).get(key, ())
    m = int(_ep_coords(mk)[rank]["model"])
    tp = EP_MESHES[mk][0][1]
    for dim, axis in enumerate(spec):
        if axis == "model":
            n = want.shape[dim] // tp
            return np.take(want, range(m * n, (m + 1) * n), axis=dim)
    return want


@pytest.mark.parametrize("lossy", ["plain", "lossy"])
@pytest.mark.parametrize("mk", list(EP_MESHES))
def test_ep_block_matches_jax(ep_runs, mk, lossy):
    """The EP block's output, aux and gradients (every MoE leaf's shard,
    the router summed over ``model``, the input) against JAX's GSPMD EP
    on the same mesh, the lossy dispatch with JAX's coins: float32
    rtol/atol 2e-4 on the output, rtol 1e-5 on the aux, rtol 1e-5 + atol
    1e-6 on the gradients."""
    inp, jax_out, ranks = ep_runs
    name = f"block_{mk}_{lossy}"
    tp = EP_MESHES[mk][0][1]
    if lossy == "lossy":     # some (sender, shard) blocks were dropped
        assert (inp[f"block_coins_{tp}"] < EP_DROP).any()
        np.testing.assert_raises(AssertionError, np.testing.assert_allclose,
                                 jax_out[name + "_y"],
                                 jax_out[f"block_{mk}_plain_y"], 2e-4, 2e-4)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[name + "_y"], jax_out[name + "_y"],
                                   **TOL["float32"])
        np.testing.assert_allclose(float(out[name + "_aux"]),
                                   float(jax_out[name + "_aux"]), rtol=1e-5)
        np.testing.assert_allclose(out[name + "_g_x"], jax_out[name + "_gx"],
                                   rtol=1e-5, atol=1e-6)
        grads = [k for k in out if k.startswith(name + "_g_")
                 and not k.endswith("_g_x")]
        assert len(grads) == 7
        for k in grads:
            leaf = k[len(name) + 3:]
            np.testing.assert_allclose(
                out[k], _block_shard(jax_out[k], leaf, mk, r), rtol=1e-5,
                atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mk", list(EP_MESHES))
def test_ep_equals_local_and_drop0_equals_off(ep_runs, mk):
    """EP = the local path at capacity 50 (JAX's own bar, on the output:
    rtol 1e-4 + atol 1e-5), against the port's local path and JAX's; the
    lossy dispatch at drop 0 is the plain one, bit for bit (output, aux
    and every gradient).  (The aux is not compared: EP's is the mean of
    each sender's load balance, which differs from the whole batch's.)"""
    _, jax_out, ranks = ep_runs
    for out in ranks:
        for want in (out["roomy_local_y"], jax_out["roomy_local_y"]):
            np.testing.assert_allclose(out[f"roomy_ep_{mk}_y"], want,
                                       rtol=1e-4, atol=1e-5)
        assert bool(out[f"drop0_{mk}"])


@pytest.mark.parametrize("case", list(EP_STEPS))
def test_ep_train_step_matches_jax(ep_runs, case):
    """One lossy-MoE train step on four ranks: (1, 4) and (2, 2) exact
    (on (2, 2) one GSPMD program in JAX, whose MoE layers route both dp
    shards' rows together) and (2, 2) ``lossy_hadamard`` (the island:
    each shard routes its own rows; the coded sync over ``data`` on the
    MoE leaves' JAX plans, with JAX's draws), each rank's shards against
    JAX's step on the same mesh: loss and aux rtol 1e-5, the synced
    gradient (first moments, gathered over ``data``) atol 1e-8, the
    updated parameters to the first AdamW update's bound."""
    _, jax_out, ranks = ep_runs
    mk, mode, _ = EP_STEPS[case]
    dims = _ep_split_dims(mk)
    tp = EP_MESHES[mk][0][1]
    eps, lr, b1 = 1e-8, OPT["lr"], 0.9
    for r, out in enumerate(ranks):
        m = int(_ep_coords(mk)[r]["model"])
        for k in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(float(out[f"{case}_m_{k}"]),
                                       float(jax_out[f"{case}_m_{k}"]),
                                       rtol=1e-5, err_msg=k)
        assert float(out[f"{case}_m_recv_frac"]) == pytest.approx(
            float(jax_out[f"{case}_m_recv_frac"]), abs=1e-7)
        assert (float(out[f"{case}_m_recv_frac"]) < 1.0) == (mode != "exact")
        for i, dim in enumerate(dims):
            # the moments come gathered whole; the parameters are shards
            want_mu, want_p = jax_out[f"{case}_mu{i}"], jax_out[f"{case}_p{i}"]
            mu = out[f"{case}_wmu{i}"]
            np.testing.assert_allclose(mu, want_mu, atol=1e-8,
                                       err_msg=f"{case} leaf {i}")
            if dim is not None:
                n = want_mu.shape[dim] // tp
                cut = range(m * n, (m + 1) * n)
                mu, want_mu, want_p = (np.take(a, cut, dim)
                                       for a in (mu, want_mu, want_p))
            g, gw = (x.astype(np.float64) / (1 - b1) for x in (mu, want_mu))
            bound = 1e-7 + 2 * lr * np.abs(g / (np.abs(g) + eps)
                                           - gw / (np.abs(gw) + eps))
            assert np.all(np.abs(out[f"{case}_p{i}"] - want_p) <= bound), (
                case, i)
