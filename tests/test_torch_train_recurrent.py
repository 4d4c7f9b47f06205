"""Training the recurrent families (recurrentgemma-9b's RG-LRU, xLSTM's
mLSTM and sLSTM): the port against the JAX package, at smoke size in
float32, on identical inputs.

(a) each block's backward: ``torch.autograd`` through the port's scans
    against ``jax.grad`` of the JAX block, on the JAX block's weights
    (its float32 gates given random values) and one numpy input and
    cotangent: the RG-LRU at S = 1,024 with B = 1 (two 512-token chunks,
    the carried state in the tape), the mLSTM at S = 128 (two 64-token
    chunks, the carried (C, n, m)) and S = 48 (padded with
    ``logi = -1e30``), the sLSTM at S = 32.  The doubling scan and the
    chunkwise form associate unlike XLA's, so the tolerance is float32
    rounding: each gradient within 1e-5 of its leaf's largest entry (plus
    rtol 1e-5); every gradient finite;
(b) the JAX leaf view (``convert.leaf_names``, ``leaf_shapes``) against
    ``tree_flatten_with_path(init_params)`` for all ten architectures,
    at smoke size with the values carried across and back, and at full
    width through ``jax.eval_shape``;
(c) loss and gradients of recurrentgemma-9b and xlstm-350m, and one
    whole step in ``exact``, ``lossy`` and ``lossy_hadamard`` with JAX's
    masks and signs, at ``tests/test_torch_train_families.py``'s
    tolerances;
(d) a recurrentgemma checkpoint that each package saves and the other
    restores, byte for byte; the launcher on the CPU.

The (4, 1) ZeRO-1 step of xlstm-350m is held to JAX's in
``tests/test_torch_train_recurrent_stubs_mesh.py``.
"""
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
from repro.models import rglru as JRG
from repro.models import xlstm as JXL
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
import repro_torch.configs as TC
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import rglru as TRG
from repro_torch.models import xlstm as TXL
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from test_torch_recurrent import _block_params
from test_torch_train_families import (DROP, MIN_CODED, MODES, OPT, _bits,
                                       _cfgs, _jax_names, _np, _trainer,
                                       check_step)

RECURRENT = ["recurrentgemma-9b", "xlstm-350m"]
ALL_ARCHS = ["qwen2-0.5b", "gemma2-9b", "chatglm3-6b", "nemotron-4-15b",
             "qwen2-moe-a2.7b", "granite-moe-3b-a800m", "recurrentgemma-9b",
             "xlstm-350m", "phi-3-vision-4.2b", "seamless-m4t-medium"]
SEQ, BATCH, STEP_KEY = 96, 2, 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# (a) the blocks' backward
# ----------------------------------------------------------------------

BLOCKS = {"rglru": ("recurrentgemma-9b", JRG.init_rglru, JRG.rglru_block,
                    TRG.rglru_block),
          "mlstm": ("xlstm-350m", JXL.init_mlstm, JXL.mlstm_block,
                    TXL.mlstm_block),
          "slstm": ("xlstm-350m", JXL.init_slstm, JXL.slstm_block,
                    TXL.slstm_block)}


def close_grads(got, want, err_msg=""):
    """Float32 rounding of a gradient: within 1e-5 of the leaf's largest
    entry, plus rtol 1e-5."""
    want = _np(want)
    assert np.isfinite(got).all(), err_msg
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


@pytest.mark.parametrize("kind,s,b", [("rglru", 1024, 1), ("mlstm", 128, 2),
                                      ("mlstm", 48, 2), ("slstm", 32, 2)])
def test_block_grads_match_jax(kind, s, b):
    arch, init, jblock, tblock = BLOCKS[kind]
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _block_params(init, 3, jcfg)
    rng = np.random.default_rng(s)
    x = (rng.standard_normal((b, s, jcfg.d_model)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jblock(p, jcfg, x)[0] * ct),
        argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, _ = tblock(leaves, tcfg, tx)
    grads = torch.autograd.grad((out * torch.as_tensor(ct)).sum(),
                                list(leaves.values()) + [tx])
    assert set(leaves) == set(jgp)
    for name, g in zip(list(leaves) + ["x"], grads):
        close_grads(g.numpy(), jgx if name == "x" else jgp[name],
                    f"{kind} S={s}: {name}")


def test_mlstm_padding_writes_nothing_backward():
    """The 48-token mLSTM pads to 64 with ``logi = -1e30``: the padded
    rows' weights are exact zeros in the backward, so the gradient equals
    that of the first 48 outputs of the unpadded 64-token input."""
    _, tcfg = _cfgs("xlstm-350m")
    _, tp = _block_params(JXL.init_mlstm, 4, _cfgs("xlstm-350m")[0])
    rng = np.random.default_rng(0)
    x64 = torch.as_tensor(rng.standard_normal((1, 64, tcfg.d_model))
                          .astype(np.float32) * 0.5)
    ct = torch.as_tensor(rng.standard_normal((1, 48, tcfg.d_model))
                         .astype(np.float32))
    grads = []
    for x in (x64[:, :48], x64):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        out, _ = TXL.mlstm_block(leaves, tcfg, x)
        grads.append(torch.autograd.grad((out[:, :48] * ct).sum(),
                                         list(leaves.values())))
    for name, a, b in zip(tp, *grads):
        assert torch.isfinite(a).all(), name
        close_grads(a.numpy(), b.numpy(), name)


# ----------------------------------------------------------------------
# (b) the leaf view of every architecture
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["smoke", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_leaf_view_is_jax_tree_flatten_order(arch, tier):
    """Names, order and shapes against ``tree_flatten_with_path`` of
    ``init_params`` through ``jax.eval_shape`` (nothing materialised),
    at smoke size and at full width."""
    jcfg, tcfg = ((JC.get(arch), TC.get(arch)) if tier == "full"
                  else _cfgs(arch))
    tree = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    names = convert.leaf_names(tcfg)
    assert list(names) == _jax_names(tree)
    assert convert.leaf_shapes(tcfg) == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(tree)]
    assert all(n.endswith(s) for n, s in zip(names,
                                             convert.short_names(tcfg)))


def view_round_trip(arch):
    """A smoke model's JAX leaves carried across and back: the view's
    leaves are JAX's values in JAX's dtypes (float32 gates included),
    and ``params_from_leaves`` gives the carried state dict back."""
    _, tcfg, jparams, leaves, _ = setup(arch)
    names = convert.leaf_names(tcfg)
    for name, got, want in zip(names, leaves,
                               jax.tree_util.tree_leaves(jparams)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=name)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    back = convert.params_from_leaves(leaves, tcfg)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)


@pytest.mark.parametrize("arch", RECURRENT)
def test_leaf_view_carries_the_values_across(arch):
    view_round_trip(arch)
    _, tcfg, _, leaves, _ = setup(arch)
    dtypes = dict(zip(convert.leaf_names(tcfg), (x.dtype for x in leaves)))
    gates = [n for n in dtypes if n.rsplit(".", 1)[-1] in (
        "gate_a_w", "lam", "w_if", "b_if", "b", "r_h")]
    assert gates and all(dtypes[n] == torch.float32 for n in gates)


# ----------------------------------------------------------------------
# (c) loss, gradients and whole steps on one device
# ----------------------------------------------------------------------

def make_batch(jcfg, seq, batch, seed=1, extras=False):
    """The JAX pipeline's batch; with ``extras`` a stub's image embeds
    (B, n_frontend_tokens, frontend_dim) or frames (B, seq,
    frontend_dim), float32 from a numpy seed."""
    out = dict(jpipe.make_source(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed)).global_batch(0))
    rng = np.random.default_rng(seed)
    if extras and jcfg.frontend == "vision_stub":
        out["image_embeds"] = rng.standard_normal(
            (batch, jcfg.n_frontend_tokens, jcfg.frontend_dim)
        ).astype(np.float32)
    if extras and jcfg.frontend == "audio_stub":
        out["frame_embeds"] = rng.standard_normal(
            (batch, seq, jcfg.frontend_dim)).astype(np.float32)
    return out


def tbatch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
            else torch.as_tensor(v) for k, v in batch.items()}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.cache
def setup(arch, extras=False):
    jcfg, tcfg = _cfgs(arch)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    leaves = convert.jax_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)), tcfg)
    return jcfg, tcfg, jparams, leaves, make_batch(jcfg, SEQ, BATCH,
                                                   extras=extras)


def loss_and_grads_match(arch, extras=False):
    """The port's loss and gradients against ``jax.value_and_grad`` of
    JAX's ``lm_loss``; returns the port's gradients."""
    jcfg, tcfg, jparams, leaves, batch = setup(arch, extras)
    (jloss, (jnll, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(p, jcfg, jbatch(batch)), has_aux=True))(jparams)
    loss, nll, aux, grads = tts.loss_and_grads(tcfg, leaves, tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-5)
    assert float(aux) == 0.0
    jflat = jax.tree_util.tree_leaves(jgrads)
    names = convert.leaf_names(tcfg)
    assert len(grads) == len(jflat) == len(names)
    for name, got, want in zip(names, grads, jflat):
        assert got.dtype == leaves[names.index(name)].dtype, name
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    return dict(zip(names, grads))


@pytest.mark.parametrize("arch", RECURRENT)
def test_lm_loss_and_grads_match_jax(arch):
    grads = loss_and_grads_match(arch)
    assert all(bool(g.any()) for g in grads.values())


@functools.cache
def jax_draws(arch):
    """JAX's one-device masks (at ``DROP``) and signs for every coded
    leaf (``_leaf_mask``, ``rademacher_nd(fold_in(key, 2i))``), drawn in
    one jitted call."""
    jparams = setup(arch)[2]
    plans = {i: jcoding.plan_nd(leaf.shape, None, 4096)
             for i, leaf in enumerate(jax.tree_util.tree_leaves(jparams))
             if leaf.size >= MIN_CODED}
    masks, signs = jax.jit(lambda key: (
        {i: jts._leaf_mask(key, i, 0, p.n_rot, jnp.float32(DROP))
         for i, p in plans.items()},
        {i: jcoding.rademacher_nd(jax.random.fold_in(key, 2 * i), p)
         for i, p in plans.items()}))(jax.random.PRNGKey(STEP_KEY))
    return ({i: torch.as_tensor(np.array(m)) for i, m in masks.items()},
            {i: torch.as_tensor(np.array(x)) for i, x in signs.items()})


@functools.cache
def jax_step(arch, mode, extras=False):
    """JAX's ``make_train_step`` on one device from ``setup``'s state."""
    jcfg, _, jparams, _, batch = setup(arch, extras)
    celeris = jts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED)
    step = jts.make_train_step(jcfg, None, jadamw.OptConfig(**OPT), celeris,
                               donate=False)
    state = {"params": jparams, "opt": jadamw.init_opt_state(jparams),
             "step": jnp.zeros((), jnp.int32)}
    new, metrics = step(state, jbatch(batch), jax.random.PRNGKey(STEP_KEY),
                        jnp.float32(DROP))
    return (jax.tree.map(np.asarray, new),
            {k: float(v) for k, v in metrics.items()})


def step_matches(arch, mode, extras=False):
    """One whole port step against :func:`jax_step`; returns the port's
    new state."""
    _, tcfg, _, leaves, batch = setup(arch, extras)
    jnew, jm = jax_step(arch, mode, extras)
    masks, signs = jax_draws(arch)
    names = convert.leaf_names(tcfg)
    assert "embed.table" in {names[i] for i in masks}
    step = tts.make_train_step(
        tcfg, None, tadamw.OptConfig(**OPT),
        tts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED))
    new, m = step(tts.state_from_params(list(leaves), tcfg), tbatch(batch),
                  None, DROP, masks=masks, signs=signs)
    assert int(new["step"]) == 1
    assert (float(m["recv_frac"]) < 1.0) == (mode != "exact")
    check_step(new, m, jnew, jm, names)
    return new


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_jax(arch, mode):
    """One whole step on one device, JAX's masks and signs at JAX's leaf
    indices (xLSTM's stacked 4-D ``r_h``, recurrentgemma's tail layers
    and float32 gate vectors among them)."""
    new = step_matches(arch, mode)
    names = convert.leaf_names(setup(arch)[1])
    coded = {names[i] for i in jax_draws(arch)[0]}
    if arch == "xlstm-350m":
        assert "decoder.groups[3].slstm.r_h" in coded
        assert new["params"][names.index(
            "decoder.groups[3].slstm.r_h")].dim() == 4
    else:
        assert "decoder.tail[1].rglru.w_in" in coded


# ----------------------------------------------------------------------
# (d) checkpoints across the packages; the launcher
# ----------------------------------------------------------------------

def checkpoints_cross(arch, tmp_path):
    """A port ``Trainer`` checkpoint restores in JAX's ``restore`` under
    JAX's paths, leaf for leaf; a JAX checkpoint restores in the port's
    ``Trainer``; the port reads back its own bytes."""
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


def test_recurrentgemma_checkpoints_cross_between_the_packages(tmp_path):
    checkpoints_cross("recurrentgemma-9b", tmp_path)


def launcher_runs(arch, capsys):
    """``launch/train.py --arch <arch> --smoke --device cpu --celeris``:
    two coded steps, finite losses, no kernel launched on the CPU."""
    from repro_torch.kernels import fwht as tfwht
    tfwht.launches = 0
    hist = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--celeris", "--steps", "2", "--seq-len", "32",
                         "--global-batch", "2"])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"])
    assert capsys.readouterr().out.count("step ") == 2
    assert tfwht.launches == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_launcher_on_cpu(arch, capsys):
    launcher_runs(arch, capsys)
