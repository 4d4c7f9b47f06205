"""The port's checkpoints and restart against the JAX package's, on the
CPU at smoke size.

- (a) a round trip, and a stray ``step_2.tmp`` (a crash mid-save) leaves
  ``LATEST`` at 1, in both packages;
- (b) the format: the same state saved by ``repro.checkpoint.save`` and
  by the port's ``save`` (``convert``'s copy of it) gives an identical
  ``manifest.json`` and byte-identical ``.npy`` files, and each package
  restores the other's, bfloat16 leaves bit for bit;
- (c) the fault restart of ``tests/test_training.py:79-89`` in both
  packages, float32, the port starting from JAX's weights: ``run(20,
  simulate_fault_at=12)`` with ``ckpt_every=5`` raises with ``LATEST`` at
  10; a fresh trainer starts at 10 with the saved timeout (rtol 1e-6
  against JAX's), draws JAX's resumed drop-rate history (neither package
  saves its numpy rng, so both draw from the seed again) and its losses
  stay within ``tests/test_torch_train.py``'s loss tolerance (rtol 1e-5)
  of JAX's.  The runs are ``lossy`` with no leaf large enough to code, so
  the drop rates are drawn and fed back but no row is lost: the two
  frameworks' masks (jax.random, torch) would otherwise part the
  received fractions and so the timeouts;
- (d) ``exact``: a run resumed from step k ends bit-identical to the
  uninterrupted run;
- (e) ``save_async`` writes what ``save`` writes;
- the launcher's ``--ckpt-dir``/``--ckpt-every`` on one device: a second
  launch resumes where the first stopped.
"""
import dataclasses
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro.train import trainer as jtrainer
import repro_torch.configs as TC
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

OPT = dict(lr=1e-3, warmup_steps=10, total_steps=500)
# (c): lossy with no leaf coded (the smoke model's largest holds 65,536)
NO_CODING = 10 ** 9
SMOKE = TC.get_smoke("qwen2-0.5b")
NAMES = convert.leaf_names(SMOKE)   # the 14 leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_leaves(tree):
    """A JAX parameter-shaped tree of arrays -> the port's 14 leaves."""
    return convert.jax_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, tree)), SMOKE)


def _port_state(jstate):
    """``convert``'s copy of a JAX train state."""
    opt = jstate["opt"]
    scalar = lambda x: torch.as_tensor(np.array(x))
    return {"params": _port_leaves(jstate["params"]),
            "opt": {"master": _port_leaves(opt["master"]),
                    "mu": _port_leaves(opt["mu"]),
                    "nu": _port_leaves(opt["nu"]),
                    "count": scalar(opt["count"])},
            "step": scalar(jstate["step"])}


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@functools.cache
def _jax_state():
    """JAX's smoke state (bfloat16 parameters) with random moments and
    count and step at 3."""
    st = jts.init_state(jax.random.PRNGKey(0), JC.get_smoke("qwen2-0.5b"))
    rng = np.random.default_rng(0)
    for part in ("mu", "nu"):
        st["opt"][part] = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape)
                                  .astype(np.float32) ** (1 + (part == "nu"))),
            st["opt"][part])
    st["opt"]["count"] = jnp.int32(3)
    st["step"] = jnp.int32(3)
    return st


def test_round_trip_and_atomicity_match_jax(tmp_path):
    jstate = _jax_state()
    state = _port_state(jstate)
    for pkg, save, latest in (("jax", lambda d, s: jckpt.save(d, s, jstate),
                               jckpt.latest_step),
                              ("port", lambda d, s: tckpt.save(
                                  d, s, tts.state_leaves(state, NAMES)),
                               tckpt.latest_step)):
        d = str(tmp_path / pkg)
        assert latest(d) is None
        save(d, 1)
        # a crash mid-save leaves a .tmp dir; LATEST still points at 1
        os.makedirs(os.path.join(d, "step_2.tmp"))
        assert latest(d) == 1
    got, step, extra = tckpt.restore(str(tmp_path / "port"),
                                     tts.state_leaves(state, NAMES))
    assert step == 1 and extra == {}
    for (_, want), x in zip(tts.state_leaves(state, NAMES), got):
        assert x.dtype == want.dtype
        np.testing.assert_array_equal(_bits(x), _bits(want))
    _, jstep, _ = jckpt.restore(str(tmp_path / "jax"), jstate)
    assert jstep == step == 1
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tts.state_leaves(state, NAMES))


def test_format_is_jaxs_byte_for_byte(tmp_path):
    jstate = _jax_state()
    state = _port_state(jstate)
    extra = {"timeout": 1.75, "arch": "qwen2-0.5b-smoke"}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jdir, 3, jstate, extra=extra)
    tckpt.save(tdir, 3, tts.state_leaves(state, NAMES), extra=extra)
    a, b = os.path.join(jdir, "step_3"), os.path.join(tdir, "step_3")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 4 * 14 + 3
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    with open(os.path.join(b, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {m["dtype"] for m in manifest["leaves"]}
    assert dtypes == {"bfloat16", "float32", "int32"}
    assert open(os.path.join(jdir, "LATEST")).read() == open(
        os.path.join(tdir, "LATEST")).read() == "3"

    # JAX restores the port's checkpoint, the port JAX's
    jgot, step, jextra = jckpt.restore(tdir, jstate)
    assert step == 3 and jextra == extra
    for x, y in zip(jax.tree.leaves(jgot), jax.tree.leaves(jstate)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                                      np.asarray(y).reshape(-1).view(np.uint8))
    got, step, textra = tckpt.restore(jdir, tts.state_leaves(state, NAMES))
    assert step == 3 and textra == extra
    restored = tts.state_from_leaves(got)
    assert restored["params"][-2].dtype == torch.bfloat16
    for (_, want), x in zip(tts.state_leaves(state, NAMES),
                            [x for _, x in tts.state_leaves(restored, NAMES)]):
        assert x.dtype == want.dtype and x.shape == want.shape
        np.testing.assert_array_equal(_bits(x), _bits(want))


def test_save_async_writes_what_save_writes(tmp_path):
    state = _port_state(_jax_state())
    tckpt.save(str(tmp_path / "sync"), 3, tts.state_leaves(state, NAMES),
               {"timeout": 2.0})
    tckpt.save_async(str(tmp_path / "async"), 3,
                     tts.state_leaves(state, NAMES),
                     {"timeout": 2.0}).result()
    cmp = filecmp.dircmp(tmp_path / "sync" / "step_3",
                         tmp_path / "async" / "step_3")
    assert not cmp.left_only and not cmp.right_only
    for name in cmp.common_files:
        assert filecmp.cmp(tmp_path / "sync" / "step_3" / name,
                           tmp_path / "async" / "step_3" / name,
                           shallow=False), name


def test_restore_refuses_another_tree(tmp_path):
    state = _port_state(_jax_state())
    tckpt.save(str(tmp_path), 1, tts.state_leaves(state, NAMES))
    leaves = tts.state_leaves(state, NAMES)
    with pytest.raises(ValueError, match="leaves to restore"):
        tckpt.restore(str(tmp_path), leaves[:-1])
    swapped = [leaves[1], leaves[0]] + leaves[2:]
    with pytest.raises(ValueError, match="in the checkpoint"):
        tckpt.restore(str(tmp_path), swapped)


def _cfgs():
    return (dataclasses.replace(JC.get_smoke("qwen2-0.5b"), dtype="float32"),
            dataclasses.replace(TC.get_smoke("qwen2-0.5b"), dtype="float32"))


def _jax_trainer(d, cfg):
    dc = jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=8, seed=1)
    return jtrainer.Trainer(
        cfg, data_cfg=dc, opt_cfg=jadamw.OptConfig(**OPT),
        celeris=jts.CelerisConfig(mode="lossy", min_coded_size=NO_CODING),
        ckpt_dir=d, ckpt_every=5)


def _port_trainer(d, cfg, mode="lossy", leaves=None):
    """A port trainer, from ``leaves`` (JAX's initial weights) when
    given, else restored from ``d``."""
    tr = ttrainer.Trainer(
        cfg, data_cfg=tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                       global_batch=8, seed=1),
        opt_cfg=tadamw.OptConfig(**OPT),
        celeris=tts.CelerisConfig(mode=mode, min_coded_size=NO_CODING),
        ckpt_dir=d, ckpt_every=5, device="cpu")
    if leaves is not None:
        tr.state = tts.state_from_params(leaves, cfg)
    return tr


def test_fault_restart_resumes_as_jax_does(tmp_path):
    jcfg, tcfg = _cfgs()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j1 = _jax_trainer(jdir, jcfg)
    weights = _port_leaves(j1.state["params"])
    with pytest.raises(RuntimeError, match="simulated node failure"):
        j1.run(20, simulate_fault_at=12)
    t1 = _port_trainer(tdir, tcfg, leaves=weights)
    with pytest.raises(RuntimeError, match="simulated node failure at "
                       "step 12"):
        t1.run(20, simulate_fault_at=12)
    assert jckpt.latest_step(jdir) == tckpt.latest_step(tdir) == 10

    j2 = _jax_trainer(jdir, jcfg)
    t2 = _port_trainer(tdir, tcfg)
    assert t2.start_step == j2.start_step == 10
    with open(os.path.join(tdir, "step_10", "manifest.json")) as f:
        saved = json.load(f)["extra"]
    assert saved["arch"] == tcfg.name
    assert t2.controller.timeout == saved["timeout"]
    np.testing.assert_allclose(t2.controller.timeout, j2.controller.timeout,
                               rtol=1e-6)
    jh, th = j2.run(5), t2.run(5)
    assert th["drop_rate"] == jh["drop_rate"]
    assert len(set(th["drop_rate"])) > 1        # drawn, not constant
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    assert int(t2.state["step"]) == 15 and t2.start_step == 15


def test_exact_resume_is_bit_identical(tmp_path):
    _, tcfg = _cfgs()
    weights = tts.init_state(torch.Generator().manual_seed(0),
                             tcfg)["params"]
    ref = _port_trainer(None, tcfg, "exact", weights)
    ref.run(8)
    t1 = _port_trainer(str(tmp_path), tcfg, "exact", weights)
    with pytest.raises(RuntimeError):
        t1.run(8, simulate_fault_at=6)
    t2 = _port_trainer(str(tmp_path), tcfg, "exact")
    assert t2.start_step == 5
    t2.run(3)
    for (path, want), (_, got) in zip(tts.state_leaves(ref.state, NAMES),
                                      tts.state_leaves(t2.state, NAMES)):
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=path)


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
            "--seq-len", "32", "--global-batch", "2", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    tlaunch.main(args + ["--steps", "2"])
    assert tckpt.latest_step(str(tmp_path)) == 2
    tlaunch.main(args + ["--steps", "1"])
    steps = [l.split()[1] for l in capsys.readouterr().out.splitlines()
             if l.startswith("step ")]
    assert steps == ["0", "1", "2"]
