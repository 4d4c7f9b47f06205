"""Training the dense families and granite-moe on one device: the port
against the JAX package, at smoke size in float32, on identical inputs.

chatglm3-6b (partial rotary, QKV bias, 2 kv heads, untied embeddings),
nemotron-4-15b (squared ReLU with no ``wg``, no bias, untied), gemma2-9b
(two pattern groups, local and global attention, both softcaps,
post-norms, GeGLU, tied) and granite-moe-3b-a800m (an MoE block with no
shared experts and no QKV bias).  The JAX weights are carried across
(``params_from_jax``), the batches come from the JAX data pipeline, and
the JAX step's own per-leaf masks and signs (``_leaf_mask``,
``rademacher_nd(fold_in(key, 2i))``) are handed to the port's step.
The sequence (96 tokens) is longer than gemma2's smoke window (64), so
its local mask binds in the forward and the backward.

Tolerances are ``tests/test_torch_train.py``'s: loss and gradients rtol
1e-5 / atol 1e-6; one whole step: loss rtol 1e-5, recv_frac exact, the
first moments atol 1e-8, each updated parameter within AdamW's
conditioning bound.  granite-moe's routing ids are asserted equal first,
on a forward with JAX under ``jax.disable_jit`` (a top-k flip must show
as a flip); its gradients and whole steps, float32, are jitted, as
``tests/test_torch_moe.py``'s are.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint import checkpoint as jckpt
from repro.core import coding as jcoding
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
import repro_torch.configs as TC
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

FAMILIES = ["chatglm3-6b", "nemotron-4-15b", "gemma2-9b",
            "granite-moe-3b-a800m"]
MOE = "granite-moe-3b-a800m"
MIN_CODED, DROP = 1024, 0.1
SEQ, BATCH = 96, 2                  # over gemma2's 64-token smoke window
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=500)
MODES = ["exact", "lossy", "lossy_hadamard"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a, np.float32)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(JC.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(TC.get_smoke(arch), dtype=dtype, **kw))


def _jax_names(tree):
    """``tree_flatten_with_path``'s paths written as the port's names."""
    return ["".join(f".{e.key}" if hasattr(e, "key") else f"[{e.idx}]"
                    for e in path)[1:]
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.cache
def _setup(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    leaves = convert.jax_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)), tcfg)
    batch = jpipe.make_source(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=1)).global_batch(0)
    return jcfg, tcfg, jparams, leaves, batch


def _tbatch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _routes_agree(arch):
    """granite-moe: both sides route the batch's tokens to the same
    experts in every layer (a forward at the step's weights, JAX op by
    op), asserted before any tolerance."""
    if arch != MOE:
        return
    jcfg, tcfg, jparams, leaves, batch = _setup(arch)
    got = {"jax": [], "torch": []}

    def recording(fn, ids, to_np):
        def rec(*a, **k):
            out = fn(*a, **k)
            ids.append(to_np(out[1]))
            return out
        return rec

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMOE, "_route", recording(JMOE._route, got["jax"],
                                             np.asarray))
        mp.setattr(TMOE, "_route", recording(TMOE._route, got["torch"],
                                             lambda t: t.numpy()))
        with jax.disable_jit():
            JM.forward(jparams, jcfg,
                       {"tokens": jnp.asarray(batch["tokens"])}, remat=False)
        TM.hidden_aux(convert.params_from_leaves(leaves, tcfg), tcfg,
            torch.as_tensor(batch["tokens"]))
    assert len(got["jax"]) == len(got["torch"]) == tcfg.n_layers
    for i, (j, t) in enumerate(zip(got["jax"], got["torch"])):
        np.testing.assert_array_equal(t, j, err_msg=f"layer {i}'s routing")


VIEW_CASES = [(a, "smoke") for a in FAMILIES] + [
    (a, "full") for a in FAMILIES] + [("gemma2-9b", "tail")]


@pytest.mark.parametrize("arch,tier", VIEW_CASES)
def test_leaf_view_matches_jax(arch, tier):
    """Names, order and shapes against JAX's ``tree_flatten_with_path``:
    at smoke size with the values carried across and back
    (``params_from_leaves``), at full width through ``jax.eval_shape``
    (nothing materialised), and gemma2 at 3 layers, whose third is a
    ``tail`` layer."""
    if tier == "full":
        jcfg, tcfg = JC.get(arch), TC.get(arch)
        tree = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                              jax.random.PRNGKey(0))
    else:
        jcfg, tcfg = _cfgs(arch, **({"n_layers": 3} if tier == "tail"
                                    else {}))
        tree = JM.init_params(jax.random.PRNGKey(1), jcfg)
    names = convert.leaf_names(tcfg)
    flat = jax.tree_util.tree_leaves(tree)
    assert list(names) == _jax_names(tree)
    assert convert.leaf_shapes(tcfg) == [tuple(x.shape) for x in flat]
    short = convert.short_names(tcfg)
    assert len(short) == len(names) and all(
        n.endswith(s) for n, s in zip(names, short))
    if tier == "tail":
        assert any(n.startswith("decoder.tail[0].") for n in names)
        assert any(n.startswith("decoder.groups[1].") for n in names)
    if tier == "full":
        return
    params = convert.params_from_jax(jax.tree.map(np.asarray, tree))
    leaves = convert.jax_leaves(params, tcfg)
    for got, want in zip(leaves, flat):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    back = convert.params_from_leaves(leaves, tcfg)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jparams, leaves, batch = _setup(arch)
    _routes_agree(arch)
    (jloss, (jnll, jaux)), jgrads = jax.value_and_grad(
        lambda p: JM.lm_loss(p, jcfg, _jbatch(batch)), has_aux=True)(jparams)
    loss, nll, aux, grads = tts.loss_and_grads(tcfg, leaves, _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    assert (float(aux) > 0) == (arch == MOE)
    jflat = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jflat) == len(convert.leaf_names(tcfg))
    for name, got, want in zip(convert.leaf_names(tcfg), grads, jflat):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_gemma2_window_binds_in_the_backward():
    """At 96 tokens gemma2's 64-token window masks keys in its local
    layers: the gradients differ from those of the same weights with a
    window that masks nothing, in both packages alike."""
    _, tcfg, _, leaves, batch = _setup("gemma2-9b")
    wide = dataclasses.replace(tcfg, window_size=4096)
    *_, g = tts.loss_and_grads(tcfg, leaves, _tbatch(batch))
    *_, g_wide = tts.loss_and_grads(wide, leaves, _tbatch(batch))
    names = convert.leaf_names(tcfg)
    local = names.index("decoder.groups[0].attn.wq")
    assert not torch.allclose(g[local], g_wide[local], rtol=1e-3, atol=0)
    assert tcfg.attn_softcap and tcfg.logit_softcap and SEQ > tcfg.window_size


@functools.cache
def _jax_step(arch, mode):
    jcfg, _, jparams, _, batch = _setup(arch)
    celeris = jts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED)
    step = jts.make_train_step(jcfg, None, jadamw.OptConfig(**OPT), celeris,
                               donate=False)
    state = {"params": jparams, "opt": jadamw.init_opt_state(jparams),
             "step": jnp.zeros((), jnp.int32)}
    key = jax.random.PRNGKey(5)
    new, metrics = step(state, _jbatch(batch), key, jnp.float32(DROP))
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
            {k: float(v) for k, v in metrics.items()}, masks, signs)


def check_step(new, m, jnew, jm, names):
    """``tests/test_torch_train.py``'s tolerances for one whole step."""
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), jm["aux"], rtol=1e-5,
                               atol=1e-7)
    assert float(m["recv_frac"]) == pytest.approx(jm["recv_frac"], abs=1e-7)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-6)
    eps, lr, b1 = 1e-8, OPT["lr"], 0.9
    jleaves = jax.tree_util.tree_leaves(jnew["params"])
    jmu = jax.tree_util.tree_leaves(jnew["opt"]["mu"])
    assert len(new["params"]) == len(jleaves) == len(names)
    for name, got, want, mu, want_mu in zip(names, new["params"], jleaves,
                                            new["opt"]["mu"], jmu):
        np.testing.assert_allclose(mu.numpy(), want_mu, atol=1e-8,
                                   err_msg=name)
        g = np.abs(want_mu) / (1 - b1)
        dg = np.abs(mu.numpy() - want_mu) / (1 - b1)
        bound = 1e-7 + 2 * lr * eps * dg / (g + eps) ** 2
        assert np.all(np.abs(got.numpy() - want) <= bound), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch, mode):
    """One whole step on one device against JAX's ``make_train_step``,
    with JAX's masks and signs at JAX's leaf indices (gemma2's group-1
    leaves and the untied ``embed.unembed`` included)."""
    _, tcfg, _, leaves, batch = _setup(arch)
    _routes_agree(arch)
    jnew, jm, masks, signs = _jax_step(arch, mode)
    names = convert.leaf_names(tcfg)
    coded = {names[i] for i in masks}
    assert "embed.table" in coded
    if not tcfg.tie_embeddings:
        assert "embed.unembed" in coded
    if len(tcfg.block_pattern) > 1:
        assert "decoder.groups[1].mlp.wi" in coded
    step = tts.make_train_step(
        tcfg, None, tadamw.OptConfig(**OPT),
        tts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED))
    new, m = step(tts.state_from_params(list(leaves), tcfg), _tbatch(batch),
                  None, DROP, masks=masks, signs=signs)
    assert int(new["step"]) == 1
    if mode != "exact":
        assert float(m["recv_frac"]) < 1.0
    check_step(new, m, jnew, jm, names)


def _trainer(tcfg, ckpt_dir=None, **kw):
    return ttrainer.Trainer(
        tcfg, data_cfg=tpipe.DataConfig(tcfg.vocab_size, 32, 2, seed=1),
        opt_cfg=tadamw.OptConfig(**OPT),
        celeris=tts.CelerisConfig(mode="lossy_hadamard",
                                  min_coded_size=MIN_CODED),
        ckpt_dir=ckpt_dir, ckpt_every=1, device="cpu", **kw)


def _bits(x):
    x = x.detach()
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


@pytest.mark.parametrize("arch", ["gemma2-9b", "chatglm3-6b"])
def test_checkpoints_cross_between_the_packages(arch, tmp_path):
    """A ``Trainer`` checkpoint of gemma2 (two pattern groups) and of
    chatglm3 (untied ``embed.unembed``) restores in JAX's ``restore``
    leaf for leaf, under JAX's own paths; a JAX checkpoint restores in
    the port's ``Trainer`` the same way."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    names = convert.leaf_names(tcfg)
    jstate = jts.init_state(jax.random.PRNGKey(4), jcfg)
    tr = _trainer(tcfg, str(tmp_path / "port"))
    tr.run(1)
    got, step, extra = jckpt.restore(str(tmp_path / "port"), jstate)
    assert int(step) == 1 and extra["arch"] == tcfg.name
    mine = tts.state_leaves(tr.state, names)
    jflat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(jflat) == len(mine) == 4 * len(names) + 2
    for (path, want), (jpath, x) in zip(mine, jflat):
        assert jax.tree_util.keystr(jpath) == path
        assert np.asarray(x).shape == tuple(want.shape)
        np.testing.assert_array_equal(_np(x), want.float().numpy(),
                                      err_msg=path)
    jckpt.save(str(tmp_path / "jax"), 5, jstate, {"timeout": 3.0})
    back = _trainer(tcfg, str(tmp_path / "jax"))
    assert back.start_step == 5 and back.controller.timeout == 3.0
    for (path, x), want in zip(tts.state_leaves(back.state, names),
                               jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(_np(want), x.float().numpy(),
                                      err_msg=path)
    leaves, _, _ = tckpt.restore(str(tmp_path / "port"),
                                 tts.state_leaves(back.state, names))
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(
        leaves, [x for _, x in tts.state_leaves(tr.state, names)]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_launcher_on_cpu(arch, capsys):
    """``launch/train.py --arch <family> --smoke --device cpu``: two
    coded steps, finite losses, no kernel launched on the CPU."""
    from repro_torch.kernels import fwht as tfwht
    tfwht.launches = 0
    hist = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--celeris", "--steps", "2", "--seq-len", "32",
                         "--global-batch", "2"])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"])
    assert capsys.readouterr().out.count("step ") == 2
    assert tfwht.launches == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_split_is_unambiguous(arch):
    """Every short name that repeats (gemma2's two groups) is split alike
    in each group, so the layers read one answer from
    ``ModelGroup.split``; the logits' leaf splits over the vocabulary
    whenever the guard lets it."""
    from repro_torch.launch import mesh as tmesh
    from test_torch_dp_train import fake_world
    cfg = TC.get(arch)
    with fake_world(4):
        for shape in ((2, 2), (1, 4)):
            mesh = tmesh.make_host_mesh(shape, device_type="cpu")
            tp = convert.model_group(cfg, mesh)
            dims = convert.split_dims(convert.leaf_shapes(cfg), mesh,
                                      convert.leaf_names(cfg))
            by_name = {}
            for n, d in zip(convert.short_names(cfg), dims):
                by_name.setdefault(n, set()).add(d is None)
            assert all(len(v) == 1 for v in by_name.values())
            assert (TM.logits_leaf(cfg) in tp.split) == (
                cfg.vocab_size % shape[1] == 0)
