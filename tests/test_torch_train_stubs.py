"""Training the modality stubs (phi-3-vision-4.2b's image frontend,
seamless-m4t-medium's encoder stack and cross-attention): the port
against the JAX package, at smoke size in float32, on identical inputs.

(a) the leaf view carries JAX's values across and back (``frontend_proj``,
    ``enc_norm``, the ``encoder`` stack, ``xattn``/``lnx``);
(b) loss and gradients with the extras given by hand (image embeds
    (B, 16, 64), frames (B, 96, 64), float32 from a numpy seed), and on
    the text alone, where every leaf the text does not reach gets a
    gradient of exact zeros, as under ``jax.grad``;
(c) one whole step with the extras in ``exact``, ``lossy`` and
    ``lossy_hadamard``, and on the text alone in ``exact`` and
    ``lossy_hadamard`` (the unused leaves' first moments stay exact
    zeros and AdamW's decoupled decay moves them as JAX's does), with
    JAX's masks and signs, at ``tests/test_torch_train_families.py``'s
    tolerances;
(d) a ``Trainer`` run, tokens only, against JAX's ``Trainer`` from the
    same weights (the loss curve rtol 1e-5, the drawn drop rates equal);
    a seamless checkpoint that each package saves and the other
    restores, byte for byte; the launcher on the CPU.

The (4, 1) data-parallel steps (seamless with the frames split by rows,
phi-3-vision with its image embeds) are held to JAX's in
``tests/test_torch_train_recurrent_stubs_mesh.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro.train import trainer as jtrainer
from repro_torch.data import pipeline as tpipe
from repro_torch.models import convert
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer
from test_torch_train_families import OPT, _cfgs
from test_torch_train_recurrent import (checkpoints_cross, jax_step,
                                        launcher_runs, loss_and_grads_match,
                                        setup, step_matches, view_round_trip)

STUBS = ["phi-3-vision-4.2b", "seamless-m4t-medium"]
# the leaves a batch of text alone does not reach
UNUSED = {"phi-3-vision-4.2b": ("frontend_proj",),
          "seamless-m4t-medium": ("frontend_proj", "enc_norm.", "encoder.",
                                  ".xattn.", ".lnx.")}
NO_CODING = 10 ** 9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unused(arch, names):
    return [n for n in names if any(u in n for u in UNUSED[arch])]


@pytest.mark.parametrize("arch", STUBS)
def test_leaf_view_carries_the_values_across(arch):
    view_round_trip(arch)
    names = convert.leaf_names(setup(arch)[1])
    assert names[-1] == "frontend_proj"
    if arch == "seamless-m4t-medium":
        assert names.index("embed.table") < names.index("enc_norm.scale") \
            < names.index("encoder.groups[0].attn.wq") \
            < names.index("final_norm.scale")
        assert "decoder.groups[0].xattn.wq" in names
        assert "encoder.groups[0].xattn.wq" not in names


@pytest.mark.parametrize("extras", [True, False], ids=["extras", "text"])
@pytest.mark.parametrize("arch", STUBS)
def test_lm_loss_and_grads_match_jax(arch, extras):
    grads = loss_and_grads_match(arch, extras)
    idle = unused(arch, grads)
    assert idle
    for name in idle:
        assert bool(grads[name].any()) == extras, name
    assert all(bool(g.any()) for n, g in grads.items() if n not in idle)


@pytest.mark.parametrize("mode", ["exact", "lossy", "lossy_hadamard"])
@pytest.mark.parametrize("arch", STUBS)
def test_train_step_with_extras_matches_jax(arch, mode):
    step_matches(arch, mode, extras=True)


@pytest.mark.parametrize("mode", ["exact", "lossy_hadamard"])
@pytest.mark.parametrize("arch", STUBS)
def test_text_only_step_decays_the_unused_leaves_as_jax(arch, mode):
    """Tokens only, as JAX's Trainer runs a stub: the whole step equals
    JAX's; the leaves the text does not reach keep zero moments and end
    at JAX's decayed values, ``w - lr wd w`` (the zero norm scales stay
    zero), within rtol 1e-6 (the step's ``lr`` tolerance: XLA may fuse
    the update, a last-bit difference)."""
    new = step_matches(arch, mode)
    _, tcfg, _, leaves, _ = setup(arch)
    jnew, _ = jax_step(arch, mode, False)
    names = convert.leaf_names(tcfg)
    jleaves = dict(zip(names, (np.asarray(x) for x in
                               jax.tree_util.tree_leaves(jnew["params"]))))
    moved = 0
    for name in unused(arch, names):
        i = names.index(name)
        assert not new["opt"]["mu"][i].any() and not new["opt"]["nu"][i].any()
        got = new["params"][i]
        np.testing.assert_allclose(got.numpy(), jleaves[name], rtol=1e-6,
                                   atol=0, err_msg=name)
        # the norms' zero scales stay zero; every other weight decays
        assert torch.equal(got, leaves[i]) == (not leaves[i].any()), name
        moved += bool(leaves[i].any())
    assert moved


@pytest.mark.parametrize("arch", STUBS)
def test_trainer_matches_jax_trainer_on_text(arch):
    """Three steps of each package's ``Trainer`` on the same pipeline
    batches (tokens only) from JAX's initial weights: the drawn drop
    rates equal, the losses within rtol 1e-5 (``lossy`` with nothing
    coded, so no mask is drawn)."""
    jcfg, tcfg = _cfgs(arch)
    jt = jtrainer.Trainer(
        jcfg, data_cfg=jpipe.DataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=32, global_batch=4, seed=1),
        opt_cfg=jadamw.OptConfig(**OPT),
        celeris=jts.CelerisConfig(mode="lossy", min_coded_size=NO_CODING))
    tt = ttrainer.Trainer(
        tcfg, data_cfg=tpipe.DataConfig(vocab_size=tcfg.vocab_size,
                                        seq_len=32, global_batch=4, seed=1),
        opt_cfg=tadamw.OptConfig(**OPT),
        celeris=tts.CelerisConfig(mode="lossy", min_coded_size=NO_CODING),
        device="cpu")
    tt.state = tts.state_from_params(convert.jax_leaves(
        convert.params_from_jax(jax.tree.map(np.asarray,
                                             jt.state["params"])), tcfg),
        tcfg)
    jh, th = jt.run(3), tt.run(3)
    assert th["drop_rate"] == jh["drop_rate"]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    assert int(tt.state["step"]) == 3


def test_seamless_checkpoints_cross_between_the_packages(tmp_path):
    checkpoints_cross("seamless-m4t-medium", tmp_path)


@pytest.mark.parametrize("arch", STUBS)
def test_train_launcher_on_cpu(arch, capsys):
    launcher_runs(arch, capsys)
