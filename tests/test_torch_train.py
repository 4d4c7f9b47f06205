"""The port's training slice against the JAX package's, at smoke size in
float32, on identical inputs.

The JAX weights are carried across (``params_from_jax``), the batches
come from the same numpy pipeline, and the per-leaf arrival masks and
rotation signs of the JAX step (``_leaf_mask``, ``rademacher_nd(
fold_in(key, 2i))``) are handed to the port's step, since jax.random and
torch draw different bits.  Tolerances, all float32 on the CPU:

- loss and gradients: rtol 1e-5, atol 1e-6 (the two frameworks sum the
  same terms in different orders);
- AdamW on identical gradients: rtol 1e-6, atol 1e-7;
- one train step: loss rtol 1e-5; the first moments, i.e. the synced
  gradient g' times (1 - b1) = 0.1, atol 1e-8 everywhere; recv_frac
  exact (the same masks).  The first AdamW update is lr * g' / (|g'| +
  eps), whose slope eps / (|g'| + eps)^2 magnifies a gradient
  difference by up to 1/eps = 1e8 where |g'| is below eps.  So each
  updated parameter is held to 1e-7 plus twice lr times that slope
  times its own gradient difference: away from |g'| ~ eps this is under
  1e-6; at a few entries with |g'| ~ 1e-9 it reaches ~1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core import coding as jcoding
from repro.core import timeout as jtimeout
from repro.core.transport import coupling as jcoupling
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro.train import trainer as jtrainer
import repro_torch.configs as TC
from repro_torch.core import timeout as ttimeout
from repro_torch.core.transport import coupling as tcoupling
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import fwht as tfwht
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer
from test_torch_dp_train import fake_world

MIN_CODED = 1024        # codes the same 8 leaves as the full-width model
DROP = 0.1
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=500)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only add
    overhead, and under parallel test workers they oversubscribe the
    cores (a 1 s test took two minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a, np.float32)


def _cfgs(n_layers=None):
    j = dataclasses.replace(JC.get_smoke("qwen2-0.5b"), dtype="float32")
    t = dataclasses.replace(TC.get_smoke("qwen2-0.5b"), dtype="float32")
    if n_layers is not None:
        j = dataclasses.replace(j, n_layers=n_layers)
        t = dataclasses.replace(t, n_layers=n_layers)
    return j, t


@functools.cache
def _setup():
    jcfg, tcfg = _cfgs()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    leaves = convert.jax_leaves(convert.params_from_jax(host), tcfg)
    src = jpipe.make_source(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4, seed=1))
    batch = src.global_batch(0)
    return jcfg, tcfg, jparams, host, leaves, batch


def _tbatch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}


@pytest.mark.parametrize("n_layers", [None, 3])
def test_leaf_view_order_and_shapes_match_jax(n_layers):
    jcfg, tcfg = _cfgs(n_layers)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = ["".join(f".{e.key}" if hasattr(e, "key") else f"[{e.idx}]"
                     for e in path)[1:] for path, _ in flat]
    assert names == list(convert.leaf_names(tcfg))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    leaves = convert.jax_leaves(params, tcfg)
    assert len(leaves) == len(flat) == 14
    for got, (_, want) in zip(leaves, flat):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    back = convert.params_from_leaves(leaves, tcfg)
    assert set(back) == set(params)
    for k, v in params.items():
        assert torch.equal(back[k], v)


def test_lm_loss_and_grads_match_jax():
    jcfg, tcfg, jparams, _, leaves, batch = _setup()
    (jloss, (jnll, jaux)), jgrads = jax.value_and_grad(
        lambda p: JM.lm_loss(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jparams)
    loss, nll, aux, grads = tts.loss_and_grads(tcfg, leaves, _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-5)
    assert float(aux) == float(jaux) == 0.0
    for got, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-6)


def test_apply_updates_matches_jax():
    rng = np.random.default_rng(3)
    shapes = [(64, 32), (7,), (3, 5, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [rng.standard_normal(s).astype(np.float32) * 0.5 for s in shapes]
    cfg = dict(OPT, warmup_steps=2)
    jstate = jadamw.init_opt_state([jnp.asarray(p) for p in params])
    tstate = tadamw.init_opt_state([torch.as_tensor(p) for p in params])
    jp, tp = [jnp.asarray(p) for p in params], [torch.as_tensor(p)
                                                for p in params]
    for _ in range(3):      # through warmup into the cosine
        jp, jstate, jm = jadamw.apply_updates(
            jp, [jnp.asarray(g) for g in grads], jstate,
            jadamw.OptConfig(**cfg))
        tp, tstate, tm = tadamw.apply_updates(
            tp, [torch.as_tensor(g) for g in grads], tstate,
            tadamw.OptConfig(**cfg))
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(tstate["count"]) == int(jstate["count"]) == 3
    for key in ("master", "mu", "nu"):
        for got, want in zip(tstate[key], jstate[key]):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                                       atol=1e-7)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                                   atol=1e-7)


def test_schedule_matches_jax():
    steps = np.arange(0, 600, 7)
    for cfg in (OPT, dict(OPT, warmup_steps=0, total_steps=1)):
        want = jadamw.schedule(jadamw.OptConfig(**cfg), jnp.asarray(steps))
        got = tadamw.schedule(tadamw.OptConfig(**cfg), torch.as_tensor(steps))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6)


@functools.cache
def _jax_step(mode):
    jcfg, _, jparams, _, _, batch = _setup()
    celeris = jts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED)
    step = jts.make_train_step(jcfg, None, jadamw.OptConfig(**OPT), celeris,
                               donate=False)
    state = {"params": jparams, "opt": jadamw.init_opt_state(jparams),
             "step": jnp.zeros((), jnp.int32)}
    key = jax.random.PRNGKey(5)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        key, jnp.float32(DROP))
    # the step's own per-leaf draws, to hand to the port
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


@pytest.mark.parametrize("mode", ["exact", "lossy", "lossy_hadamard"])
def test_train_step_matches_jax(mode):
    _, tcfg, _, _, leaves, batch = _setup()
    jnew, jm, masks, signs = _jax_step(mode)
    step = tts.make_train_step(
        tcfg, None, tadamw.OptConfig(**OPT),
        tts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED))
    state = {"params": list(leaves), "opt": tadamw.init_opt_state(leaves),
             "step": torch.zeros((), dtype=torch.int32)}
    new, m = step(state, _tbatch(batch), None, DROP, masks=masks,
                  signs=signs)
    assert len(masks) == 8
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
    assert float(m["recv_frac"]) == pytest.approx(jm["recv_frac"],
                                                  abs=1e-7)
    if mode != "exact":
        assert float(m["recv_frac"]) < 1.0
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-6)
    assert int(new["step"]) == 1
    jleaves = jax.tree_util.tree_leaves(jnew["params"])
    jmu = jax.tree_util.tree_leaves(jnew["opt"]["mu"])
    eps, lr, b1 = 1e-8, OPT["lr"], 0.9
    for got, want, mu, want_mu in zip(new["params"], jleaves,
                                      new["opt"]["mu"], jmu):
        np.testing.assert_allclose(mu.numpy(), want_mu, atol=1e-8)
        g = np.abs(want_mu) / (1 - b1)
        dg = np.abs(mu.numpy() - want_mu) / (1 - b1)
        bound = 1e-7 + 2 * lr * eps * dg / (g + eps) ** 2
        assert np.all(np.abs(got.numpy() - want) <= bound)


def test_lossy_step_draws_the_same_masks_in_both_lossy_modes():
    """lossy and lossy_hadamard lose the same rows from one generator."""
    _, tcfg, _, _, leaves, batch = _setup()
    fracs = []
    for mode in ("lossy", "lossy_hadamard"):
        step = tts.make_train_step(
            tcfg, None, tadamw.OptConfig(**OPT),
            tts.CelerisConfig(mode=mode, min_coded_size=MIN_CODED))
        state = {"params": list(leaves),
                 "opt": tadamw.init_opt_state(leaves),
                 "step": torch.zeros((), dtype=torch.int32)}
        _, m = step(state, _tbatch(batch),
                    torch.Generator().manual_seed(9), 0.3)
        fracs.append(float(m["recv_frac"]))
    assert fracs[0] == fracs[1] < 0.8


def test_lossy_step_needs_a_draw_source():
    _, tcfg, _, _, leaves, batch = _setup()
    step = tts.make_train_step(
        tcfg, None, tadamw.OptConfig(**OPT),
        tts.CelerisConfig(mode="lossy_hadamard", min_coded_size=MIN_CODED))
    state = {"params": list(leaves), "opt": tadamw.init_opt_state(leaves),
             "step": torch.zeros((), dtype=torch.int32)}
    masks = {i: torch.ones(4096, dtype=torch.bool) for i in range(14)
             if leaves[i].numel() >= MIN_CODED}
    with pytest.raises(ValueError, match="generator"):
        step(state, _tbatch(batch), None, DROP, masks=masks)   # no signs


def test_unported_paths_raise():
    _, tcfg = _cfgs()
    with fake_world(4):
        tp = tmesh.make_host_mesh((2, 2), device_type="cpu")
        # tensor parallelism builds: a model group of 2
        assert tts.make_train_step(tcfg, tp).model_group.size == 2
        with pytest.raises(ValueError, match="needs a 'pod' mesh axis"):
            tts.make_train_step(tcfg, tp, None,
                                tts.CelerisConfig(mode="hierarchical"))
    # gradient accumulation builds; fewer than one microbatch raises
    assert tts.make_train_step(tcfg, None, None, None,
                               microbatches=2).model_group is None
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_train_step(tcfg, None, None, None, microbatches=0)
    # lossy_moe is inert on a dense model, as in JAX: the same step as
    # off, bit for bit
    _, _, _, _, leaves, batch = _setup()
    ends = []
    for on in (False, True):
        step = tts.make_train_step(tcfg, None, tadamw.OptConfig(**OPT),
                                   tts.CelerisConfig(lossy_moe=on))
        new, m = step(tts.state_from_params(list(leaves), tcfg),
                      _tbatch(batch), None, DROP)
        ends.append(new["params"] + new["opt"]["mu"] + [m["loss"]])
    assert all(torch.equal(a, b) for a, b in zip(*ends))


@pytest.mark.parametrize("mode", list(jcoupling.CollectiveMode))
def test_collective_mode_matches_jax(mode):
    t = tcoupling.CollectiveMode.parse(mode.value.replace("_", "+"))
    assert t.value == mode.value
    assert (t.lossy, t.coded, t.hierarchical) == (
        mode.lossy, mode.coded, mode.hierarchical)
    assert (tts.CelerisConfig(mode=mode.value).collective_mode().value
            == jts.CelerisConfig(mode=mode.value).collective_mode().value)
    assert (tts.CelerisConfig().collective_mode().value      # the defaults
            == jts.CelerisConfig().collective_mode().value)
    assert tcoupling.MAX_DROP == jcoupling.MAX_DROP


def test_straggler_model_bit_identical():
    j, t = jtrainer.StragglerModel(), ttrainer.StragglerModel()
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    for timeout in np.linspace(0.3, 6.0, 40):
        assert t.drop_rate(timeout, tr) == j.drop_rate(timeout, jr)


def test_timeout_controller_bit_identical():
    cfg = dict(init_timeout=2.0, min_timeout=0.5, max_timeout=8.0)
    j = jtimeout.TimeoutController(jtimeout.TimeoutConfig(**cfg))
    t = ttimeout.TimeoutController(ttimeout.TimeoutConfig(**cfg))
    rng = np.random.default_rng(0)
    for _ in range(30):
        dur, frac = rng.uniform(0.5, 3.0), rng.choice([1.0, 0.9, 0.5, 0.0])
        assert t.update(dur, frac) == j.update(dur, frac)
        reports = list(rng.uniform(0.1, 9.0, 8))
        assert ttimeout.coordinate(reports) == jtimeout.coordinate(reports)
        assert t.adopt(reports[0]) == j.adopt(reports[0])
    sm = rng.uniform(0.5, 3.0, 16)
    fr = rng.uniform(0.0, 1.0, 16)
    for got, want in zip(
            ttimeout.update_array(sm, 1.3, fr, ttimeout.TimeoutConfig()),
            jtimeout.update_array(sm, 1.3, fr, jtimeout.TimeoutConfig())):
        np.testing.assert_array_equal(got, want)
    assert (ttimeout.adopt_scalar(11.0, ttimeout.TimeoutConfig())
            == jtimeout.adopt_scalar(11.0, jtimeout.TimeoutConfig()))


@pytest.mark.parametrize("kind", ["markov", "uniform"])
def test_data_batches_bit_identical(kind):
    cfg = dict(vocab_size=700, seq_len=24, global_batch=8, seed=3, kind=kind)
    j = jpipe.make_source(jpipe.DataConfig(**cfg))
    t = tpipe.make_source(tpipe.DataConfig(**cfg))
    for step, shards in ((0, 1), (5, 1), (5, 4)):
        want, got = j.global_batch(step, shards), t.global_batch(step, shards)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_trainer_runs_three_lossy_hadamard_steps_on_cpu():
    _, tcfg = _cfgs()
    tfwht.launches = 0
    tr = ttrainer.Trainer(
        tcfg, data_cfg=tpipe.DataConfig(tcfg.vocab_size, 32, 4, seed=1),
        opt_cfg=tadamw.OptConfig(**OPT),
        celeris=tts.CelerisConfig(mode="lossy_hadamard",
                                  min_coded_size=MIN_CODED),
        device="cpu")
    seen = []
    hist = tr.run(3, on_metrics=lambda s, m: seen.append((s, m)))
    assert [s for s, _ in seen] == [0, 1, 2]
    assert np.isfinite(hist["loss"]).all()
    assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"])
    assert all(0.0 <= d <= 0.5 for d in hist["drop_rate"])
    assert int(tr.state["step"]) == 3 and tr.start_step == 3
    assert tfwht.launches == 0                     # CPU: plain versions


def test_coded_training_learns_under_loss_on_cpu():
    """tests/test_distribution.py:60-89's check on one device: 14 coded
    steps at drop 0.05 bring the mean loss of the last 3 below the
    first 3, receiving 90-100 % of the wire rows."""
    _, tcfg = _cfgs()
    src = tpipe.make_source(tpipe.DataConfig(tcfg.vocab_size, 64, 8, seed=1))
    step = tts.make_train_step(
        tcfg, None, tadamw.OptConfig(lr=1e-3),
        tts.CelerisConfig(mode="lossy_hadamard", min_coded_size=MIN_CODED))
    state = tts.init_state(torch.Generator().manual_seed(0), tcfg)
    losses, fracs = [], []
    for i in range(14):
        state, m = step(state, _tbatch(src.global_batch(i)),
                        torch.Generator().manual_seed(100 + i), 0.05)
        losses.append(float(m["loss"]))
        fracs.append(float(m["recv_frac"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert all(0.9 < f < 1.0 for f in fracs), fracs


def test_train_launcher_on_cpu(capsys):
    hist = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--device",
                         "cpu", "--celeris", "--steps", "2", "--seq-len",
                         "32", "--global-batch", "2"])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "recv" in out


def test_train_launcher_raises_without_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the check is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])


def test_init_state_is_the_leaf_view_with_f32_master():
    _, tcfg = _cfgs()
    st = tts.init_state(torch.Generator().manual_seed(0), tcfg)
    assert len(st["params"]) == 14 and int(st["step"]) == 0
    for p, w, m in zip(st["params"], st["opt"]["master"], st["opt"]["mu"]):
        assert w.dtype == m.dtype == torch.float32 and w.shape == p.shape
        assert torch.equal(w, p.float()) and not m.any()
    assert torch.equal(st["params"][-2], TM.init_params(
        tcfg, torch.Generator().manual_seed(0))["embed.table"])
