"""Training the dense families and granite-moe on the DP and TP meshes:
the port's step against the JAX package's step on the same meshes, at
world size 4 on the CPU, float32 at smoke widths.

Every case runs in ONE launch of four gloo processes and ONE JAX
subprocess with four forced host devices, started together, each under
its own timeout (the pattern of ``tests/test_torch_tp_train.py``, whose
meshes and draw helpers this file shares).  The JAX side registers each
mesh (``set_global_mesh``), so its layers pin heads and vocabulary to
``model`` as in training.  Both sides get the same draws (masks per dp
peer or pod, signs, the int8 wire's noise at each leaf's global tile
shape, granite's fixed per-layer MoE coins), made from JAX's keys here;
the weights are JAX's, carried across and split by
``convert.shard_leaves``; rank r takes the rows of its dp index.

Cases:

(a) the forward: each family's logits (gathered over the vocabulary
    shards: chatglm3's and nemotron's from the column-split untied
    ``embed.unembed``, gemma2's softcapped on its shards of the tied
    table) and loss on (2, 2) and (1, 4) against JAX's (rtol 1e-5 + atol
    1e-5; loss rtol 1e-5);
(b) whole steps, ``tests/test_torch_train.py``'s tolerances on every
    rank's shards against the matching slices of JAX's result (plus one
    quantization step, ``chip_smoke.int8_step_bound``, on the int8
    wire), the ranks that share a model index bit-identical:
    gemma2 ``lossy_hadamard`` on (2, 2) and ``hierarchical`` int8 on
    (2, 1, 2); chatglm3 ``exact`` on (1, 4), where the guard keeps its
    2 kv heads whole; nemotron ``lossy`` on (2, 2); granite-moe
    expert parallel with ``lossy_moe`` at drop 0.3: ``lossy_hadamard``
    on (2, 2) and ``exact`` on (1, 4) (its 16 padded experts 4 a rank),
    and ``exact`` without it on (2, 2), where the dp ranks route the
    global batch as JAX's GSPMD step does.  (JAX cannot lower a coded
    MoE step on (1, 4): XLA's partitioner fails its check "Cross-
    partition allreduce must be in (partial) manual partitioning mode"
    for qwen2-moe as for granite-moe, so that cell has no reference);
(c) gemma2's ZeRO-1 slices on (2, 2): each rank's ``master``, ``mu`` and
    ``nu`` are its blocks, by JAX's ``zero1_specs``, of the whole state,
    bit for bit.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.core import coding as jcoding
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.train import sharding_rules as jrules
from test_torch_dp_train import (OPT, _case, _draws, _free_port, _torch_side,
                                 zero1_blocks)
from test_torch_tp_train import MESHES, _coords, _mask_rows, _stub_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, TIMEOUT = 4, 400
MIN_CODED, SEQ, BATCH = 1024, 32, 8
ARCHS = {"gemma2": "gemma2-9b", "chatglm3": "chatglm3-6b",
         "nemotron": "nemotron-4-15b", "granite": "granite-moe-3b-a800m"}
FWD_MESHES = ("dm22", "dm14")
# name -> (family, mesh, mode, quantize_wire, drop, lossy_moe)
STEP_CASES = {
    "gemma2_dm22_lh": ("gemma2", "dm22", "lossy_hadamard", False, 0.1, False),
    "gemma2_pdm212_hier_int8": ("gemma2", "pdm212", "hierarchical", True,
                                [0.02, 0.0, 0.1], False),
    "chatglm3_dm14_exact": ("chatglm3", "dm14", "exact", False, 0.0, False),
    "nemotron_dm22_lossy": ("nemotron", "dm22", "lossy", False, 0.1, False),
    "granite_dm22_lh_moe": ("granite", "dm22", "lossy_hadamard", False, 0.3,
                            True),
    "granite_dm14_exact_moe": ("granite", "dm14", "exact", False, 0.3, True),
    "granite_dm22_exact": ("granite", "dm22", "exact", False, 0.0, False)}
STEP_KEY = 7
ZERO_CASES = ("gemma2_dm22_lh",)

JAX_SIDE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro import sharding as shd
from repro.models import model as M
from repro.optim import adamw
from repro.train import train_step as ts
d = sys.argv[1]
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
meshes = {k: shd.make_mesh(tuple(v[0]), tuple(v[1]))
          for k, v in meta["meshes"].items()}
cfgs = {k: dataclasses.replace(C.get_smoke(a), dtype="float32")
        for k, a in meta["archs"].items()}
params = {k: M.init_params(jax.random.PRNGKey(0), c) for k, c in cfgs.items()}
out = {}

def batch_of(n):
    return {k: jnp.asarray(inp[f"{k}_n{n}"]) for k in ("tokens", "labels")}

# (a) the forward on the TP meshes
for k, cfg in cfgs.items():
    for mk in meta["fwd_meshes"]:
        shd.set_global_mesh(meshes[mk])
        b = batch_of(1)
        out[f"fwd_{k}_{mk}_logits"] = np.asarray(jax.jit(
            lambda p: M.forward(p, cfg, b)[0])(params[k]))
        out[f"fwd_{k}_{mk}_loss"] = np.asarray(jax.jit(
            lambda p: M.lm_loss(p, cfg, b)[0])(params[k]))

# (b) whole steps
for name, (k, mk, mode, q, drop, lmoe) in meta["step_cases"].items():
    mesh = meshes[mk]
    shd.set_global_mesh(mesh)
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q, lossy_moe=lmoe)
    step = ts.make_train_step(cfgs[k], mesh, adamw.OptConfig(**meta["opt"]),
                              cel, donate=False)
    p = params[k]
    state = {"params": p, "opt": adamw.init_opt_state(p),
             "step": jnp.zeros((), jnp.int32)}
    new, m = step(state, batch_of(meta["n_dp"][name]),
                  jax.random.PRNGKey(meta["step_key"]),
                  jnp.asarray(drop, jnp.float32))
    leaves = jax.tree_util.tree_leaves
    for i, (w, mu) in enumerate(zip(leaves(new["params"]),
                                    leaves(new["opt"]["mu"]))):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = (np.asarray(w),
                                                     np.asarray(mu))
    for key, v in m.items():
        out[f"{name}_m_{key}"] = np.asarray(v)
shd.set_global_mesh(None)
np.savez(d + "/jax.npz", **out)
"""

TORCH_SIDE = """
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        rank=rank, world_size=4)
torch.set_num_threads(1)
import chip_smoke
import repro_torch.configs as C
from repro_torch import sharding as shd
from repro_torch.models import convert, model as M
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
t = lambda a: torch.as_tensor(np.array(a))
meshes = {k: shd.make_mesh(tuple(v[0]), tuple(v[1]), "cpu")
          for k, v in meta["meshes"].items()}
cfgs = {k: dataclasses.replace(C.get_smoke(a), dtype="float32")
        for k, a in meta["archs"].items()}
names = {k: convert.leaf_names(c) for k, c in cfgs.items()}
leaves = {k: [t(inp[f"{k}_leaf{i}"]) for i in range(len(names[k]))]
          for k in cfgs}
opt = adamw.OptConfig(**meta["opt"])
out = {}

def batch_of(n, peer=0):
    rows = inp["tokens_n%d" % n].shape[0] // n
    return {k: t(inp[f"{k}_n{n}"][peer * rows:(peer + 1) * rows]).long()
            for k in ("tokens", "labels")}

def axes(mesh, axis_names):
    return ts._Axes(shd.group(mesh, axis_names),
                    shd.axis_size(mesh, axis_names),
                    shd.peer_index(mesh, axis_names))

# (a) the forward: the logits gathered over the vocabulary shards
for k, cfg in cfgs.items():
    for mk in meta["fwd_meshes"]:
        mesh = meshes[mk]
        tp = convert.model_group(cfg, mesh)
        params = convert.params_from_leaves(
            convert.shard_leaves(leaves[k], mesh, names[k]), cfg)
        b = batch_of(1)
        logits = M.forward(params, cfg, b["tokens"], tp=tp)
        if M.logits_leaf(cfg) in tp.split:
            logits = shd.model_all_gather(logits, tp)
        out[f"fwd_{k}_{mk}_logits"] = logits.numpy()
        out[f"fwd_{k}_{mk}_loss"] = M.lm_loss(params, cfg, b, tp)[0].numpy()

# (b) whole steps
for name, (k, mk, mode, q, drop, lmoe) in meta["step_cases"].items():
    mesh, cfg = meshes[mk], cfgs[k]
    dp = shd.dp_axes(mesh)
    batch = batch_of(meta["n_dp"][name], shd.peer_index(mesh, dp))
    mine = convert.shard_leaves(leaves[k], mesh, names[k])
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q, lossy_moe=lmoe)
    step = ts.make_train_step(cfg, mesh, opt, cel)
    row = meta["mask_peer"][name][rank]
    coded = [int(key[len(name) + 5:]) for key in inp.files
             if key.startswith(name + "_mask")]
    masks = {i: t(inp[f"{name}_mask{i}"][row]) for i in coded}
    signs = {i: t(inp[f"{name}_signs{i}"]) for i in coded}
    noise = {i: t(inp[f"{name}_noise{i}"]) for i in coded
             if f"{name}_noise{i}" in inp.files}
    coins = ([t(c) for c in inp["coins_%d" % step.model_group.size]]
             if lmoe else None)
    new, m = step(ts.state_from_params(mine, cfg, mesh), batch, None, drop,
                  masks=masks, signs=signs, noise=noise, coins=coins)
    mu = chip_smoke.over_data(new, step.data_group)["opt"]["mu"]
    for i, (p, u) in enumerate(zip(new["params"], mu)):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = p.numpy(), u.numpy()
    for key, v in m.items():
        out[f"{name}_m_{key}"] = v.numpy()
    out[f"{name}_n_coded"] = np.int64(len(coded))
    if name in meta["zero_cases"]:
        save_zero(name, new, cfg, mesh)
    if q:
        plans = ts.plan_leaves(convert.leaf_shapes(cfg), mesh, cel, names[k])
        if mode == "hierarchical":
            lossy, exact = axes(mesh, ("pod",)), axes(mesh, ("data",))
        else:
            lossy, exact = axes(mesh, dp), None
        bound = chip_smoke.int8_step_bound(cfg, mine, batch, plans, masks,
                                           signs, lossy, exact,
                                           step.model_group)
        for i, b in bound.items():
            out[f"{name}_bound{i}"] = np.float64(b)
np.savez(d + "/rank%d.npz" % rank, **out)
dist.destroy_process_group()
"""


@functools.cache
def _cfg(k):
    return dataclasses.replace(JC.get_smoke(ARCHS[k]), dtype="float32")


@functools.cache
def _params(k):
    return JM.init_params(jax.random.PRNGKey(0), _cfg(k))


def _n_dp(mk):
    shape, names = MESHES[mk]
    return int(np.prod([n for n, a in zip(shape, names) if a != "model"]))


def _split_dims(mk, k):
    """Each leaf's dim split over ``model`` (JAX's specs), or None."""
    specs = jax.tree_util.tree_leaves(
        jrules.param_specs(_params(k), _stub_mesh(mk)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [next((j for j, s in enumerate(spec) if s == "model"), None)
            for spec in specs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_families_mesh"))
    inp = {}
    for k in ARCHS:
        for i, leaf in enumerate(jax.tree_util.tree_leaves(_params(k))):
            inp[f"{k}_leaf{i}"] = np.asarray(leaf)
    src = jpipe.make_source(jpipe.DataConfig(
        vocab_size=_cfg("gemma2").vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=1))
    for n in (1, 2, 4):
        for key, v in src.global_batch(0, n).items():
            inp[f"{key}_n{n}"] = v
    for tp in (2, 4):   # JAX's MoE coins: fold_in(PRNGKey(0), layer)
        inp[f"coins_{tp}"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(0), i), (tp, tp)))
            for i in range(_cfg("granite").n_layers)])
    key = jax.random.PRNGKey(STEP_KEY)
    mask_peer, n_dp = {}, {}
    for name, (k, mk, mode, q, drop, _) in STEP_CASES.items():
        rows, rates = _mask_rows(mk, mode, drop)
        mask_peer[name], n_dp[name] = rows, _n_dp(mk)
        if mode == "exact":
            continue
        dims = _split_dims(mk, k)
        for i, (leaf, sd) in enumerate(zip(
                jax.tree_util.tree_leaves(_params(k)), dims)):
            if leaf.size < MIN_CODED:
                continue
            plan = jcoding.plan_nd(leaf.shape, sd, 4096)
            for kind, v in _draws(key, i, plan, range(len(rates)), rates,
                                  q).items():
                inp[f"{name}_{kind}{i}"] = v
    meta = {"meshes": MESHES, "archs": ARCHS, "fwd_meshes": FWD_MESHES,
            "step_cases": STEP_CASES, "step_key": STEP_KEY,
            "min_coded": MIN_CODED, "opt": OPT, "mask_peer": mask_peer,
            "n_dp": n_dp, "zero_cases": ZERO_CASES}
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]), OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    port = str(_free_port())
    procs += [subprocess.Popen(
        [sys.executable, "-c", _torch_side(TORCH_SIDE), str(r), port, d],
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
    load = functools.partial(np.load, allow_pickle=False)
    return (inp, dict(load(os.path.join(d, "jax.npz"))),
            [dict(load(os.path.join(d, f"rank{r}.npz")))
             for r in range(WORLD)])


def _shard_of(want, case, mk, k, rank):
    """JAX's full step result cut to ``rank``'s shards of ``case``."""
    dims = _split_dims(mk, k)
    m = int(_coords(mk)[rank]["model"])
    tp = dict(zip(MESHES[mk][1], MESHES[mk][0]))["model"]
    out = dict(want)
    for i, dim in enumerate(dims):
        if dim is None:
            continue
        for kind in ("p", "mu"):
            full = want[f"{case}_{kind}{i}"]
            n = full.shape[dim] // tp
            out[f"{case}_{kind}{i}"] = np.take(full, range(m * n, (m + 1) * n),
                                               axis=dim)
    return out


def _check_step(got, want, name, n_leaves, bounds=None):
    """``tests/test_torch_train.py``'s tolerances; ``bounds`` (int8) adds
    one quantization step of each coded leaf's gradient to its first
    moment's tolerance, and the parameters' bound takes the update
    difference whole (``tests/test_torch_dp_train.py``'s check)."""
    eps, lr, b1 = 1e-8, OPT["lr"], 0.9
    for i in range(n_leaves):
        mu, want_mu = got[f"{name}_mu{i}"], want[f"{name}_mu{i}"]
        atol = 1e-8 + (1 - b1) * (bounds or {}).get(i, 0.0)
        np.testing.assert_allclose(mu, want_mu, atol=atol,
                                   err_msg=f"{name} leaf {i}")
        g, g_want = (m.astype(np.float64) / (1 - b1) for m in (mu, want_mu))
        bound = 1e-7 + 2 * lr * np.abs(g / (np.abs(g) + eps)
                                       - g_want / (np.abs(g_want) + eps))
        assert np.all(np.abs(got[f"{name}_p{i}"] - want[f"{name}_p{i}"])
                      <= bound), (name, i)


@pytest.mark.parametrize("mk", FWD_MESHES)
@pytest.mark.parametrize("k", list(ARCHS))
def test_forward_on_the_tp_mesh_matches_jax(runs, k, mk):
    _, jax_out, ranks = runs
    name = f"fwd_{k}_{mk}"
    assert jax_out[name + "_logits"].shape[-1] == _cfg(k).vocab_size
    for out in ranks:
        np.testing.assert_allclose(out[name + "_logits"],
                                   jax_out[name + "_logits"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(out[name + "_loss"]),
                                   float(jax_out[name + "_loss"]), rtol=1e-5)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_on_the_mesh_matches_jax(runs, case):
    _, jax_out, ranks = runs
    k, mk, mode, q, _, lmoe = STEP_CASES[case]
    n_leaves = len(jax.tree_util.tree_leaves(_params(k)))
    for r, out in enumerate(ranks):
        want = _shard_of(_case(jax_out, case), case, mk, k, r)
        for key in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(float(out[f"{case}_m_{key}"]),
                                       float(want[f"{case}_m_{key}"]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        assert float(out[f"{case}_m_recv_frac"]) == pytest.approx(
            float(want[f"{case}_m_recv_frac"]), abs=1e-7)
        bounds = ({int(key[len(case) + 6:]): float(v)
                   for key, v in _case(out, case, "bound").items()}
                  if q else None)
        if q:
            assert len(bounds) == int(out[f"{case}_n_coded"]) > 0
        _check_step(out, want, case, n_leaves, bounds)
    # the ranks that share a model index end the step bit-identical
    coords = _coords(mk)
    for r, out in enumerate(ranks):
        first = next(s for s in range(WORLD)
                     if coords[s]["model"] == coords[r]["model"])
        for key, v in _case(ranks[first], case).items():
            np.testing.assert_array_equal(out[key], v, err_msg=key)
    frac = float(ranks[0][f"{case}_m_recv_frac"])
    assert frac == 1.0 if mode == "exact" else frac < 1.0
    assert (float(ranks[0][f"{case}_m_aux"]) > 0) == (k == "granite")


@pytest.mark.parametrize("case", ZERO_CASES)
def test_each_rank_holds_its_zero1_slices(runs, case):
    _, _, ranks = runs
    k, mk = STEP_CASES[case][:2]
    specs = [tuple(p) for p in jax.tree_util.tree_leaves(
        jrules.zero1_specs(_params(k), _stub_mesh(mk)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    n_split = zero1_blocks(ranks, case, *MESHES[mk], specs)
    assert n_split == len(specs)   # every leaf has a dim that 2 divides
    # the whole moments, cut to each rank's model shards, are the step's
    # (held to JAX's by the step check)
    tp = dict(zip(MESHES[mk][1], MESHES[mk][0]))["model"]
    for r, out in enumerate(ranks):
        m = int(_coords(mk)[r]["model"])
        for i, dim in enumerate(_split_dims(mk, k)):
            whole = out[f"{case}_wmu{i}"]
            if dim is not None:
                n = whole.shape[dim] // tp
                whole = np.take(whole, range(m * n, (m + 1) * n), axis=dim)
            np.testing.assert_array_equal(whole, out[f"{case}_mu{i}"])
