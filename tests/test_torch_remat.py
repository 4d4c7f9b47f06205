"""Remat in the port's training loss (``model.lm_loss(remat=True)``, the
default, as JAX's): each unit of ``len(block_pattern)`` layers, and each
tail layer, runs under ``torch.utils.checkpoint`` and is recomputed in
the backward.

- every architecture's smoke config (its own dtype, bf16): the loss and
  every gradient with remat equal those without, bit for bit; the stubs
  with their extras (the encoder's units too), qwen2-moe with the lossy
  dispatch on and fixed coins; remat saves fewer tensors for the backward
  outside the checkpoints;
- against JAX's ``lm_loss`` (remat by default) on JAX's weights, float32,
  at ``tests/test_torch_train.py``'s tolerances (loss rtol 1e-5,
  gradients rtol 1e-5 / atol 1e-6): qwen2, gemma2 at 3 layers (a local +
  global unit and a local tail), recurrentgemma at 5 (an rglru, rglru,
  local unit and a two-layer tail), seamless with frames (the encoder);
- the reckoning on meta tensors (``launch/costs.trace_costs``) of phase
  6j's cell, qwen2-0.5b at 24 layers on 4 rows of 4,096 tokens: the
  ``lossy_hadamard`` step (``launch/dryrun.one_device_cell``, which
  remats) peaks under the card's 80 GB and below the loss and its
  gradients without remat, and does more matmul FLOPs than they do.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
import repro_torch
import repro_torch.configs as TC
from repro_torch.configs import ShapeConfig
from repro_torch.launch import costs, dryrun, specs
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serve import serve_step
from test_torch_train_recurrent import (_np, jbatch, make_batch, setup,
                                        tbatch)

SEQ, BATCH = 48, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loss_and_grads(cfg, params, batch, remat, lossy=None):
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = TM.lm_loss(p, cfg, batch, lossy=lossy, remat=remat)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(p, grads))


def saved_tensors(cfg, params, batch, remat, lossy=None):
    """The tensors the forward saves for the backward outside the
    checkpoints (a checkpoint keeps its own)."""
    n = [0]

    def pack(t):
        n[0] += 1
        return t

    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TM.lm_loss(p, cfg, batch, lossy=lossy, remat=remat)
    return n[0]


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg = TC.get_smoke(arch)
    g = repro_torch.generator("cpu", 0)
    params = TM.init_params(cfg, g)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g)
    batch = {"tokens": tokens, "labels": tokens,
             **serve_step.frontend_inputs(cfg, BATCH, SEQ, g)}
    lossy = None
    if cfg.moe is not None:
        lossy = TM.LossyCtx(enabled=True, drop_rate=0.1, coins=[
            TMOE.layer_coins(i, 1) for i in range(cfg.n_layers)])
    loss0, g0 = loss_and_grads(cfg, params, batch, False, lossy)
    loss1, g1 = loss_and_grads(cfg, params, batch, True, lossy)
    assert torch.isfinite(loss0)
    assert torch.equal(loss0, loss1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    if cfg.frontend:
        proj = g1["frontend_proj"]
        assert proj.abs().sum() > 0       # the extras reach the loss
    assert (saved_tensors(cfg, params, batch, True, lossy)
            < saved_tensors(cfg, params, batch, False, lossy))


JAX_CASES = {"qwen2-0.5b": {}, "gemma2-9b": {"n_layers": 3},
             "recurrentgemma-9b": {}, "seamless-m4t-medium": {}}


@pytest.mark.parametrize("arch", list(JAX_CASES))
def test_remat_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jparams, leaves, _ = setup(arch)
    kw = JAX_CASES[arch]
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    if kw:
        jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
        leaves = convert.jax_leaves(convert.params_from_jax(
            jax.tree.map(np.asarray, jparams)), tcfg)
    plen = len(tcfg.block_pattern)
    assert tcfg.n_layers // plen >= 1
    if arch in ("gemma2-9b", "recurrentgemma-9b"):
        assert tcfg.n_layers % plen       # a unit and a tail
    batch = make_batch(jcfg, SEQ, BATCH, extras=tcfg.is_encdec)
    (jloss, (jnll, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(p, jcfg, jbatch(batch)), has_aux=True))(jparams)
    names = convert.leaf_names(tcfg)
    loss, grads = loss_and_grads(
        tcfg, convert.params_from_leaves(leaves, tcfg), tbatch(batch), True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    by_leaf = convert.jax_leaves(grads, tcfg)
    jflat = jax.tree_util.tree_leaves(jgrads)
    assert len(by_leaf) == len(jflat) == len(names)
    for name, got, want in zip(names, by_leaf, jflat):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    if tcfg.is_encdec:
        enc = [g for n, g in zip(names, by_leaf) if n.startswith("encoder")]
        assert enc and all(bool(g.any()) for g in enc)


def test_reckoned_peak_of_the_full_width_remat_cell():
    cfg = TC.get("qwen2-0.5b")
    shape = ShapeConfig("one_device", 4096, 4, "train")
    params = convert.params_from_leaves(
        [p.local for p in specs.abstract_params(cfg)], cfg)
    batch = specs.locals_of(specs.train_input_specs(cfg, shape))
    without = costs.trace_costs(loss_and_grads, cfg, params, batch, False)
    step = dryrun.one_device_cell("qwen2-0.5b", 4, 4096)
    assert step["layers"] == 24
    assert step["peak_bytes"] < without["peak_bytes"]
    assert step["peak_bytes"] < 80e9 and step["fits"]
    # the recompute adds a forward (the update and the coded sync add no
    # matmul)
    assert step["costs"]["matmul_flops"] > without["matmul_flops"]
