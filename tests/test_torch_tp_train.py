"""The port's tensor-parallel train step (a ``model`` mesh axis larger
than 1) and gradient accumulation against the JAX package's train step
on the same meshes, at world size 4 on the CPU.

Every case runs in ONE launch of four gloo processes and ONE JAX
subprocess with four forced host devices, started together, each under
its own timeout (the pattern of ``tests/test_torch_dp_train.py``).  The
JAX side registers each mesh (``set_global_mesh``), so its layers pin
their heads and vocabulary to ``model`` as in training.  Both sides get
the same draws: this file makes JAX's (masks per dp peer or pod, signs,
and the int8 wire's noise at each leaf's global tile shape) and hands
each rank its own as tensors.  The weights are JAX's, carried across
and split by ``convert.shard_leaves``; rank r takes the rows of its dp
index.  Meshes: (2, 2) data x model, (1, 4) data x model and (2, 1, 2)
pod x data x model.  The smoke config covers the three kv layouts: at
tp 2 its one kv head of 18 columns is split in storage but not by heads
(case b), at tp 4 the guard keeps wk/wv whole (case c), and with 8 q
and 2 kv heads each rank of tp 2 holds its own kv head (case a).

Cases, all float32:

(a) the forward: the logits gathered over the vocabulary shards and the
    loss on (2, 2) and (1, 4) against JAX's (rtol 1e-5 + atol 1e-5,
    loss rtol 1e-5);
(b) one whole step in every mode on (2, 2), the kv case (a) config,
    ``hierarchical`` int8 on (2, 1, 2) and exact on (1, 4):
    ``tests/test_torch_train.py``'s tolerances on every rank's shard
    against the matching slice of JAX's result (plus one quantization
    step, ``chip_smoke.int8_step_bound``, on the int8 wire); the ranks
    that share a model index bit-identical;
(c) TP exact on (2, 2) and (1, 4) against the port's one-device step
    on the same global batch;
(d) ``microbatches=2`` against JAX's, on one device (where both steps
    take the batch whole) and on (2, 2);
(e) ``gather_leaves(shard_leaves(x)) == x`` and the TP ``global_norm``
    against the one-device norm (rtol 1e-6);
(f) the int8 wire's scale taken over ``model`` (and dp) against JAX's
    maximum over the global tile block (rtol 1e-6), the codes equal;
(g) ``Trainer(mesh=)`` on (2, 2) from the same shards ends its first
    step bit-identical to (b)'s exact step; ``convert.leaf_shapes`` and
    ``chip_smoke.tp_fwht_shapes`` against JAX's leaves and the plans of
    (2, 2), (1, 4) and (4, 1) DeviceMeshes;
(h) ZeRO-1 on model shards: each rank's ``master``, ``mu`` and ``nu``
    after a step on (2, 2) and (2, 1, 2) are its blocks, by JAX's
    ``zero1_specs``, of the whole state, bit for bit, and AdamW over the
    slices is the replicated update bit for bit on (2, 2) and (4, 1) (on
    (2, 1, 2) the data axis is 1 and the slices are whole; the step
    checks of (b)-(d) read the moments gathered over ``data``);
(i) the elastic restart: (g)'s trainer checkpoints on (2, 2), and
    ``Trainer(mesh=)`` restores it on (4, 1) and (1, 4), every rank's
    leaves its blocks of the gathered state, bit for bit; JAX's
    ``restore`` of the same checkpoint gives that state.
"""
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as JC
from repro.core import coding as jcoding
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.train import sharding_rules as jrules
from repro.train import train_step as jts
from repro.checkpoint import checkpoint as jckpt
from test_torch_dp_train import (OPT, _case, _check_step, _draws,
                                 _torch_side, jax_side, run_sides,
                                 zero1_blocks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, TIMEOUT = 4, 300
MIN_CODED, SEQ, BATCH = 1024, 32, 8
MESHES = {"dm22": ((2, 2), ("data", "model")),
          "dm14": ((1, 4), ("data", "model")),
          "pdm212": ((2, 1, 2), ("pod", "data", "model")),
          "dm41": ((4, 1), ("data", "model"))}
CFGS = {"smoke": {}, "kv2": {"n_heads": 8, "n_kv_heads": 2}}
# name -> (mesh or None, config, mode, quantize_wire, drop, microbatches)
STEP_CASES = {
    "dm22_exact": ("dm22", "smoke", "exact", False, 0.0, 1),
    "dm22_lossy": ("dm22", "smoke", "lossy", False, 0.1, 1),
    "dm22_lh": ("dm22", "smoke", "lossy_hadamard", False, 0.1, 1),
    "dm22_lh_int8": ("dm22", "smoke", "lossy_hadamard", True, 0.1, 1),
    "dm22_lh_mb2": ("dm22", "smoke", "lossy_hadamard", False, 0.1, 2),
    "dm22_kv2_lh": ("dm22", "kv2", "lossy_hadamard", False, 0.1, 1),
    "pdm212_hier_int8": ("pdm212", "smoke", "hierarchical", True,
                         [0.02, 0.0, 0.1], 1),
    "dm14_exact": ("dm14", "smoke", "exact", False, 0.0, 1),
    "one_lh_mb2": (None, "smoke", "lossy_hadamard", False, 0.1, 2)}
STEP_KEY = 7
# the cases whose ranks report their ZeRO-1 slices (h)
ZERO_CASES = ("dm22_lh", "pdm212_hier_int8")
# (f): a leaf of (3, 64, 96) split over model along dim 2, n_rot 128
SCALE_SHAPE, SCALE_ROT, SCALE_DROP = (3, 64, 96), 128, 0.1

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
cfgs = {k: dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32",
                               **kw) for k, kw in meta["cfgs"].items()}
params = {k: M.init_params(jax.random.PRNGKey(0), c) for k, c in cfgs.items()}
out = {}

def batch_of(n):
    return {k: jnp.asarray(inp[f"{k}_n{n}"]) for k in ("tokens", "labels")}

stage("setup")
# (a) the forward on the TP meshes; every program is traced under its
# mesh here and compiled on the pool
fwd = {}
for mk in ("dm22", "dm14"):
    shd.set_global_mesh(meshes[mk])
    b = batch_of(1)
    fwd[mk] = (compiled(jax.jit(lambda p: M.forward(p, cfgs["smoke"], b)[0]),
                        (params["smoke"],)),
               compiled(jax.jit(lambda p: M.lm_loss(p, cfgs["smoke"], b)[0]),
                        (params["smoke"],)))

# (b), (d) whole steps
steps = {}
for name, (mk, ck, mode, q, drop, mb) in meta["step_cases"].items():
    mesh = meshes[mk] if mk else None
    shd.set_global_mesh(mesh)
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q)
    step = ts.make_train_step(cfgs[ck], mesh, adamw.OptConfig(**meta["opt"]),
                              cel, donate=False, microbatches=mb)
    p = params[ck]
    state = {"params": p, "opt": adamw.init_opt_state(p),
             "step": jnp.zeros((), jnp.int32)}
    args = (state, batch_of(meta["n_dp"][name]),
            jax.random.PRNGKey(meta["step_key"]),
            jnp.asarray(drop, jnp.float32))
    steps[name] = (compiled(step, args), args)
stage("traced")
for mk, (logits, loss) in fwd.items():
    out[f"fwd_{mk}_logits"] = np.asarray(logits.result()(params["smoke"]))
    out[f"fwd_{mk}_loss"] = np.asarray(loss.result()(params["smoke"]))
for name, (prog, args) in steps.items():
    new, m = prog.result()(*args)
    leaves = jax.tree_util.tree_leaves
    for i, (w, mu) in enumerate(zip(leaves(new["params"]),
                                    leaves(new["opt"]["mu"]))):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = (np.asarray(w),
                                                     np.asarray(mu))
    for k, v in m.items():
        out[f"{name}_m_{k}"] = np.asarray(v)
shd.set_global_mesh(None)
np.savez(d + "/jax.npz", **out)
stage("compiled and run")
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
from repro_torch.core import coding
from repro_torch.models import convert, model as M
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
t = lambda a: torch.as_tensor(np.array(a))
meshes = {k: shd.make_mesh(tuple(v[0]), tuple(v[1]), "cpu")
          for k, v in meta["meshes"].items()}
cfgs = {k: dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32",
                               **kw) for k, kw in meta["cfgs"].items()}
leaves = {k: [t(inp[f"{k}_leaf{i}"]) for i in range(14)] for k in cfgs}
opt = adamw.OptConfig(**meta["opt"])
out = {}

def batch_of(n, peer=0, of=None):
    # rows of global_batch(0, n): dp peer's block of ``of`` (default n)
    of = of or n
    rows = inp["tokens_n%d" % n].shape[0] // of
    return {k: t(inp[f"{k}_n{n}"][peer * rows:(peer + 1) * rows]).long()
            for k in ("tokens", "labels")}

def save(name, new, m, dg=None):
    mu = chip_smoke.over_data(new, dg)["opt"]["mu"]
    for i, (p, u) in enumerate(zip(new["params"], mu)):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = p.numpy(), u.numpy()
    for k, v in m.items():
        out[f"{name}_m_{k}"] = v.numpy()

def axes(mesh, names):
    return ts._Axes(shd.group(mesh, names), shd.axis_size(mesh, names),
                    shd.peer_index(mesh, names))

# (a) the forward: the logits gathered over the vocabulary shards
for mk in ("dm22", "dm14"):
    mesh, cfg = meshes[mk], cfgs["smoke"]
    tp = convert.model_group(cfg, mesh)
    names = convert.leaf_names(cfg)
    params = convert.params_from_leaves(convert.shard_leaves(
        leaves["smoke"], mesh, names), cfg)
    b = batch_of(1)
    out[f"fwd_{mk}_logits"] = shd.model_all_gather(
        M.forward(params, cfg, b["tokens"], tp=tp), tp).numpy()
    out[f"fwd_{mk}_loss"] = M.lm_loss(params, cfg, b, tp)[0].numpy()

# (b), (d) whole steps
for name, (mk, ck, mode, q, drop, mb) in meta["step_cases"].items():
    mesh, cfg = (meshes[mk] if mk else None), cfgs[ck]
    dp = shd.dp_axes(mesh)
    peer = shd.peer_index(mesh, dp) if dp else 0
    batch = batch_of(meta["n_dp"][name], peer)
    mine = (convert.shard_leaves(leaves[ck], mesh, convert.leaf_names(cfg))
            if mesh else leaves[ck])
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q)
    step = ts.make_train_step(cfg, mesh, opt, cel, microbatches=mb)
    row = meta["mask_peer"][name][rank]
    coded = [int(k[len(name) + 5:]) for k in inp.files
             if k.startswith(name + "_mask")]
    masks = {i: t(inp[f"{name}_mask{i}"][row]) for i in coded}
    signs = {i: t(inp[f"{name}_signs{i}"]) for i in coded}
    noise = {i: t(inp[f"{name}_noise{i}"]) for i in coded
             if f"{name}_noise{i}" in inp.files}
    new, m = step(ts.state_from_params(mine, cfg, mesh), batch, None, drop,
                  masks=masks, signs=signs, noise=noise)
    save(name, new, m, step.data_group)
    if name in meta["zero_cases"]:
        save_zero(name, new, cfg, mesh)
    if q:
        plans = ts.plan_leaves(convert.leaf_shapes(cfg), mesh, cel,
                               convert.leaf_names(cfg))
        if mode == "hierarchical":
            lossy, exact = axes(mesh, ("pod",)), axes(mesh, ("data",))
        else:
            lossy, exact = axes(mesh, dp), None
        bound = chip_smoke.int8_step_bound(cfg, mine, batch, plans, masks,
                                           signs, lossy, exact,
                                           step.model_group)
        for i, b in bound.items():
            out[f"{name}_bound{i}"] = np.float64(b)

# (c) the port's one-device exact step on each TP mesh's global batch
if rank == 0:
    for n in (1, 2):
        fresh = list(leaves["smoke"])
        new, m = ts.make_train_step(cfgs["smoke"], None, opt)(
            ts.state_from_params(fresh, cfgs["smoke"]), batch_of(n, of=1),
            None, 0.0)
        save(f"single_n{n}", new, m)

# the Trainer on (2, 2): its rows of the batch and its step, from the
# carried weights' shards; it must end as dm22_exact does, and checkpoint
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Trainer
data_cfg = DataConfig(vocab_size=cfgs["smoke"].vocab_size, seq_len=meta["seq"],
                      global_batch=meta["batch"], seed=1)
tr = Trainer(cfgs["smoke"], data_cfg=data_cfg, opt_cfg=opt,
             mesh=meshes["dm22"], ckpt_dir=d + "/ckpt", ckpt_every=1,
             device="cpu")
names = convert.leaf_names(cfgs["smoke"])
mine = convert.shard_leaves(leaves["smoke"], meshes["dm22"], names)
tr.state = ts.state_from_params(mine, cfgs["smoke"], meshes["dm22"])
hist = tr.run(1)
save("trainer_dm22", tr.state, {"loss": torch.tensor(hist["loss"][0])},
     tr.step_fn.data_group)

# the elastic restart: the (2, 2) checkpoint on (4, 1) and (1, 4), each
# rank's leaves its blocks of the saved state (gathered here)
shapes = convert.leaf_shapes(cfgs["smoke"])
def flat_specs(mesh):
    return [s for _, s in ts.state_leaves(ts.state_specs(shapes, mesh, names),
                                          names)]
saved = list(convert.gather_state([x for _, x in ts.state_leaves(tr.state,
                                                                 names)],
                                  flat_specs(meshes["dm22"]), meshes["dm22"]))
if rank == 0:
    for i, x in enumerate(saved):
        out[f"elastic_saved{i}"] = x.numpy()
for mk in ("dm41", "dm14"):
    back = Trainer(cfgs["smoke"], data_cfg=data_cfg, opt_cfg=opt,
                   mesh=meshes[mk], ckpt_dir=d + "/ckpt", device="cpu")
    got = [x for _, x in ts.state_leaves(back.state, names)]
    want = [shd.local_slice(x, s, meshes[mk])
            for x, s in zip(saved, flat_specs(meshes[mk]))]
    out[f"elastic_{mk}"] = np.bool_(back.start_step == 1 and all(
        a.dtype == b.dtype and torch.equal(bits(a), bits(b))
        for a, b in zip(got, want)))

# ZeRO-1 against the replicated update on the meshes with data > 1
for mk in ("dm22", "dm41"):
    zero_vs_replicated(mk, cfgs["smoke"], meshes[mk],
                       convert.shard_leaves(leaves["smoke"], meshes[mk],
                                            names))

# (e) shard, gather, and the global norm
mesh = meshes["dm22"]
shapes = convert.leaf_shapes(cfgs["smoke"])
full = [t(inp[f"norm_leaf{i}"]) for i in range(14)]
shards = convert.shard_leaves(full, mesh, names)
back = convert.gather_leaves(shards, mesh, shapes, names)
out["gather_equal"] = np.bool_(all(torch.equal(a, b)
                                   for a, b in zip(back, full)))
step = ts.make_train_step(cfgs["smoke"], mesh, opt)
split = [s.shape != f.shape for s, f in zip(shards, full)]
out["norm_tp"] = adamw.global_norm(shards, step.model_group, split).numpy()
out["norm_one"] = adamw.global_norm(full).numpy()
out["n_split"] = np.int64(sum(split))

# (f) the int8 wire's scale over model and dp
tp = shd.model_group(mesh)
dp = axes(mesh, ("data",))
plan = coding.plan_nd(tuple(meta["scale_shape"]), 2, meta["scale_rot"])
ns = meta["scale_shape"][2] // tp.size
cols = slice(tp.index * ns, (tp.index + 1) * ns)
g = t(inp["scale_grad"][dp.peer])[:, :, cols]
contrib = coding.encode_nd(g, t(inp["scale_signs"]), plan) * t(
    inp["scale_mask"][dp.peer])[None, :, None].float()
codes, scale = ts._int8_wire(contrib, t(inp["scale_noise"])[:, :, cols], dp,
                             tp)
out["scale"], out["scale_codes"] = scale.numpy(), codes.numpy()
np.savez(d + "/rank%d.npz" % rank, **out)
dist.destroy_process_group()
"""


def _cfg(name):
    return dataclasses.replace(JC.get_smoke("qwen2-0.5b"), dtype="float32",
                               **CFGS[name])


def _stub_mesh(mk):
    """JAX's ``param_specs`` reads only ``mesh.shape``."""
    shape, names = MESHES[mk]
    return types.SimpleNamespace(shape=dict(zip(names, shape)))


def _coords(mk):
    """Each rank's {axis: index} on a mesh (row-major, as DeviceMesh)."""
    shape, names = MESHES[mk]
    return [dict(zip(names, np.unravel_index(r, shape)))
            for r in range(WORLD)]


def _n_dp(mk):
    if mk is None:
        return 1
    shape, names = MESHES[mk]
    return int(np.prod([n for n, a in zip(shape, names) if a != "model"]))


def _split_dims(mk, ck):
    """Each leaf's dim split over ``model`` (JAX's specs), or None."""
    jparams = JM.init_params(jax.random.PRNGKey(0), _cfg(ck))
    specs = jax.tree_util.tree_leaves(
        jrules.param_specs(jparams, _stub_mesh(mk)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [next((j for j, s in enumerate(spec) if s == "model"), None)
            for spec in specs]


def _mask_rows(mk, mode, drop):
    """(each rank's mask row, each row's rate): the dp index, or in
    hierarchical mode the pod index at its pod's combined rate."""
    if mk is None:
        return [0] * WORLD, [np.float32(drop)]
    coords = _coords(mk)
    if mode == "hierarchical":
        dr = np.asarray(drop, np.float32)
        rates = [np.minimum(np.float32(1) - (np.float32(1) - dr[p])
                            * (np.float32(1) - dr[-1]), np.float32(0.5))
                 for p in range(2)]
        return [int(c["pod"]) for c in coords], rates
    n = _n_dp(mk)
    rows = [int(np.ravel_multi_index(
        [c[a] for a in MESHES[mk][1] if a != "model"],
        [s for s, a in zip(*MESHES[mk]) if a != "model"])) for c in coords]
    return rows, [np.float32(drop)] * n


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_train"))
    rng = np.random.default_rng(0)
    inp = {}
    for ck in CFGS:
        for i, leaf in enumerate(jax.tree_util.tree_leaves(
                JM.init_params(jax.random.PRNGKey(0), _cfg(ck)))):
            inp[f"{ck}_leaf{i}"] = np.asarray(leaf)
    src = jpipe.make_source(jpipe.DataConfig(
        vocab_size=_cfg("smoke").vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=1))
    for n in (1, 2):
        for k, v in src.global_batch(0, n).items():
            inp[f"{k}_n{n}"] = v
    key = jax.random.PRNGKey(STEP_KEY)
    mask_peer, n_dp = {}, {}
    for name, (mk, ck, mode, q, drop, _) in STEP_CASES.items():
        rows, rates = _mask_rows(mk, mode, drop)
        mask_peer[name], n_dp[name] = rows, _n_dp(mk)
        if mode == "exact":
            continue
        jleaves = jax.tree_util.tree_leaves(
            JM.init_params(jax.random.PRNGKey(0), _cfg(ck)))
        # JAX plans around the model dim its guarded specs name
        dims = _split_dims(mk, ck) if mk else [None] * len(jleaves)
        for i, (leaf, sd) in enumerate(zip(jleaves, dims)):
            if leaf.size < MIN_CODED:
                continue
            plan = jcoding.plan_nd(leaf.shape, sd, 4096)
            for k, v in _draws(key, i, plan, range(len(rates)), rates,
                               q).items():
                inp[f"{name}_{k}{i}"] = v
    # (e) leaves to shard and gather
    for i, s in enumerate(inp[f"smoke_leaf{i}"].shape for i in range(14)):
        inp[f"norm_leaf{i}"] = rng.standard_normal(s).astype(np.float32)
    # (f) per dp peer a global gradient, its mask; signs and noise
    plan = jcoding.plan_nd(SCALE_SHAPE, 2, SCALE_ROT)
    inp["scale_grad"] = rng.standard_normal((2,) + SCALE_SHAPE).astype(
        np.float32)
    inp["scale_mask"] = rng.random((2, SCALE_ROT)) >= SCALE_DROP
    inp["scale_signs"] = np.where(rng.random(SCALE_ROT) < 0.5, -1.0,
                                  1.0).astype(np.float32)
    inp["scale_noise"] = rng.random((plan.tiles, SCALE_ROT,
                                     SCALE_SHAPE[2])).astype(np.float32)
    meta = {"meshes": MESHES, "cfgs": CFGS, "step_cases": STEP_CASES,
            "step_key": STEP_KEY, "min_coded": MIN_CODED, "opt": OPT,
            "seq": SEQ, "batch": BATCH,
            "mask_peer": mask_peer, "n_dp": n_dp, "zero_cases": ZERO_CASES,
            "scale_shape": SCALE_SHAPE, "scale_rot": SCALE_ROT}
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]), OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run_sides(d, jax_side(JAX_SIDE), _torch_side(TORCH_SIDE), env)
    load = functools.partial(np.load, allow_pickle=False)
    jax_out = dict(load(os.path.join(d, "jax.npz")))
    # JAX's restore of the port's (2, 2) checkpoint, into its own state
    restored, jax_out["elastic_step"], _ = jckpt.restore(
        os.path.join(d, "ckpt"),
        jts.init_state(jax.random.PRNGKey(0), _cfg("smoke")))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(restored)):
        jax_out[f"elastic_restored{i}"] = np.asarray(leaf)
    return (inp, jax_out, [dict(load(os.path.join(d, f"rank{r}.npz")))
                           for r in range(WORLD)])


def _shard_of(want, case, mk, ck, rank):
    """JAX's full step result cut to ``rank``'s shards of ``case``."""
    if mk is None:
        return want
    dims = _split_dims(mk, ck)
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


@pytest.mark.parametrize("mk", ["dm22", "dm14"])
def test_tp_forward_matches_jax(runs, mk):
    _, jax_out, ranks = runs
    for out in ranks:
        np.testing.assert_allclose(out[f"fwd_{mk}_logits"],
                                   jax_out[f"fwd_{mk}_logits"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(out[f"fwd_{mk}_loss"]),
                                   float(jax_out[f"fwd_{mk}_loss"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tp_step_matches_jax(runs, case):
    _, jax_out, ranks = runs
    mk, ck, mode, q, drop, _ = STEP_CASES[case]
    for r, out in enumerate(ranks):
        want = _shard_of(_case(jax_out, case), case, mk, ck, r)
        np.testing.assert_allclose(float(out[f"{case}_m_loss"]),
                                   float(want[f"{case}_m_loss"]), rtol=1e-5)
        assert float(out[f"{case}_m_recv_frac"]) == float(
            want[f"{case}_m_recv_frac"])
        np.testing.assert_allclose(float(out[f"{case}_m_grad_norm"]),
                                   float(want[f"{case}_m_grad_norm"]),
                                   rtol=1e-5)
        bounds = ({int(k[len(case) + 6:]): float(v)
                   for k, v in _case(out, case, "bound").items()}
                  if q else None)
        if q:
            assert len(bounds) == 8
        _check_step(out, want, case, bounds)
    # the ranks that share a model index end the step bit-identical
    if mk is not None:
        coords = _coords(mk)
        for r, out in enumerate(ranks):
            first = next(s for s in range(WORLD)
                         if coords[s]["model"] == coords[r]["model"])
            for k, v in _case(ranks[first], case).items():
                np.testing.assert_array_equal(out[k], v, err_msg=k)
    frac = float(ranks[0][f"{case}_m_recv_frac"])
    assert frac == 1.0 if mode == "exact" else frac < 1.0


@pytest.mark.parametrize("mk", ["dm22", "dm14"])
def test_tp_exact_equals_one_device(runs, mk):
    _, _, ranks = runs
    case, n = f"{mk}_exact", _n_dp(mk)
    single = {k.replace(f"single_n{n}", case): v
              for k, v in ranks[0].items() if k.startswith(f"single_n{n}_")}
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(float(out[f"{case}_m_loss"]),
                                   float(single[f"{case}_m_loss"]),
                                   rtol=1e-5)
        _check_step(out, _shard_of(single, case, mk, "smoke", r), case)


def test_microbatches_match_the_whole_batch(runs):
    """On (2, 2) the port's ``microbatches=2`` step equals its step on the
    whole rows with the same draws, within float32 rounding (each is
    also held to JAX's by ``test_tp_step_matches_jax``; on one device
    both steps take the batch whole, which ``one_lh_mb2`` holds there)."""
    _, _, ranks = runs
    whole = "dm22_lh"
    for out in ranks:
        got = {k.replace("dm22_lh_mb2", whole): v
               for k, v in _case(out, "dm22_lh_mb2").items()}
        np.testing.assert_allclose(float(got[f"{whole}_m_loss"]),
                                   float(out[f"{whole}_m_loss"]), rtol=1e-5)
        _check_step(got, out, whole)


def test_trainer_on_the_tp_mesh(runs):
    """``Trainer(mesh=)`` on (2, 2) with the carried weights' shards: its
    rows of each batch (``shard_batch`` of its dp index) and its step end
    the first step bit-identical to the exact step on those rows."""
    _, _, ranks = runs
    for out in ranks:
        want = _case(out, "dm22_exact", "p|mu")
        assert len(want) == 28
        for k, v in want.items():
            np.testing.assert_array_equal(
                out[k.replace("dm22_exact", "trainer_dm22")], v, err_msg=k)
        assert float(out["trainer_dm22_m_loss"]) == float(
            out["dm22_exact_m_loss"])


def test_shard_gather_and_global_norm(runs):
    _, _, ranks = runs
    for out in ranks:
        assert bool(out["gather_equal"])
        assert int(out["n_split"]) == 11    # all but the norms' 3 leaves
        np.testing.assert_allclose(float(out["norm_tp"]),
                                   float(out["norm_one"]), rtol=1e-6)
    for out in ranks[1:]:
        assert float(out["norm_tp"]) == float(ranks[0]["norm_tp"])


def test_int8_scale_spans_the_model_group(runs):
    """JAX's shared scale is the maximum over the global tile block
    (axes 0 and 2, the latter split over ``model``) and the dp peers."""
    inp, _, ranks = runs
    plan = jcoding.plan_nd(SCALE_SHAPE, 2, SCALE_ROT)
    signs = jnp.asarray(inp["scale_signs"])
    contribs = [jcoding.encode_nd(jnp.asarray(inp["scale_grad"][p]), signs,
                                  plan)
                * jnp.asarray(inp["scale_mask"][p])[None, :, None]
                for p in range(2)]
    absmax = jnp.max(jnp.stack([jnp.max(jnp.abs(c), axis=(0, 2))
                                for c in contribs]), axis=0)
    scale = np.asarray(jnp.where(absmax > 0, absmax / 127.0, 1.0))
    noise = jnp.asarray(inp["scale_noise"])
    ns = SCALE_SHAPE[2] // 2
    for r, out in enumerate(ranks):
        c = _coords("dm22")[r]
        np.testing.assert_allclose(out["scale"], scale, rtol=1e-6)
        codes = np.asarray(jnp.clip(jnp.floor(
            contribs[int(c["data"])] / scale[None, :, None] + noise),
            -127, 127)).astype(np.int32)
        m = int(c["model"])
        np.testing.assert_array_equal(out["scale_codes"],
                                      codes[:, :, m * ns:(m + 1) * ns])
    # a rank's own columns alone give a smaller maximum somewhere
    local = np.max(np.abs(np.asarray(contribs[0]))[:, :, :ns], axis=(0, 2))
    assert np.any(local < np.asarray(absmax))


def test_chip_smoke_fwht_shapes_are_the_tp_path():
    """``chip_smoke.tp_fwht_shapes``: the FWHT calls of a coded rank-step
    on a data x model DeviceMesh at full width, per coded leaf its tiles
    times its share of the model dim: on (2, 2) (also the default,
    phase 2's stand-in mesh), on (1, 4), and on (4, 1), where they are
    the DP path's; and at phases 6b/6c's depth
    (``chip_smoke.MESH_LAYERS``), the shapes phase 2 checks."""
    import chip_smoke
    import repro_torch.configs as TC
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import convert as tconvert
    from repro_torch.train import train_step as tts
    from test_torch_dp_train import fake_world
    cfg = TC.get("qwen2-0.5b")
    got = {}
    with fake_world():
        for shape in ((2, 2), (1, 4), (4, 1)):
            mesh = tmesh.make_host_mesh(shape, device_type="cpu")
            plans = tts.plan_leaves(tconvert.leaf_shapes(cfg), mesh,
                                    tts.CelerisConfig(mode="lossy_hadamard"),
                                    tconvert.leaf_names(cfg))
            want = [(p.tiles * p.shape[p.sharded_dim] // shape[1], p.n_rot)
                    for p in plans if p is not None]
            got[shape] = chip_smoke.tp_fwht_shapes(cfg, mesh)
            assert got[shape] == want, shape
            assert len(want) == chip_smoke.CODED_LEAVES
    assert chip_smoke.tp_fwht_shapes(cfg) == got[(2, 2)]
    assert sorted(set(got[(2, 2)])) == [(384, 4096), (3072, 4096),
                                        (14592, 4096), (151936, 512)]
    assert sorted(set(got[(1, 4)])) == [(192, 4096), (1536, 4096),
                                        (7296, 4096), (75968, 512)]
    assert sorted(set(got[(4, 1)])) == [(768, 4096), (6144, 4096),
                                        (29184, 4096), (303872, 512)]
    cut = dataclasses.replace(cfg, n_layers=chip_smoke.MESH_LAYERS)
    assert sorted(set(chip_smoke.tp_fwht_shapes(cut))) == [
        (128, 1024), (1024, 1024), (4864, 1024), (151936, 512)]


@pytest.mark.parametrize("ck", ["smoke", "kv2", "full"])
def test_leaf_shapes_are_jaxs(ck):
    """``convert.leaf_shapes``, from which the step plans and the specs
    decide what splits: the JAX parameter tree's leaf shapes."""
    import repro_torch.configs as TC
    from repro_torch.models import convert as tconvert
    jcfg, tcfg = ((JC.get("qwen2-0.5b"), TC.get("qwen2-0.5b")) if ck == "full"
                  else (_cfg(ck), dataclasses.replace(
                      TC.get_smoke("qwen2-0.5b"), dtype="float32",
                      **CFGS[ck])))
    want = [tuple(l.shape) for l in jax.tree_util.tree_leaves(jax.eval_shape(
        lambda k: JM.init_params(k, jcfg), jax.random.PRNGKey(0)))]
    assert tconvert.leaf_shapes(tcfg) == want


@pytest.mark.parametrize("case", ZERO_CASES)
def test_each_rank_holds_its_zero1_slices(runs, case):
    """(h) Each rank's ``master``, ``mu`` and ``nu`` after the step: its
    block, by JAX's ``zero1_specs``, of the whole leaves (its model
    shard of them, split again over ``data``)."""
    _, _, ranks = runs
    mk, ck = STEP_CASES[case][:2]
    specs = [tuple(p) for p in jax.tree_util.tree_leaves(
        jrules.zero1_specs(JM.init_params(jax.random.PRNGKey(0), _cfg(ck)),
                           _stub_mesh(mk)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    n_split = zero1_blocks(ranks, case, *MESHES[mk], specs)
    # (2, 1, 2) has no data axis to split over: the slices are whole
    data = dict(zip(MESHES[mk][1], MESHES[mk][0]))["data"]
    if data == 1:
        assert n_split == 0
    else:   # the port's data group splits the leaves JAX's specs split
        assert n_split == int(ranks[0][f"zero_sliced_{mk}"]) >= 11


@pytest.mark.parametrize("mk", ["dm22", "dm41"])
def test_zero1_update_is_the_replicated_update(runs, mk):
    """(h) AdamW over the ZeRO-1 slices of model shards: the replicated
    update's parameters and state slices, bit for bit."""
    _, _, ranks = runs
    for out in ranks:
        assert bool(out[f"zero_same_{mk}"])
        assert int(out[f"zero_sliced_{mk}"]) >= 11


def test_elastic_restart_across_meshes(runs):
    """(i) ``tests/test_distribution.py:138-159`` for the port: the
    trainer's checkpoint on (2, 2) (ZeRO-1 slices of model shards,
    gathered by every rank, written by rank 0) restores through
    ``Trainer(mesh=...)`` on (4, 1) and (1, 4) with every rank's leaves its
    blocks of the saved state, bit for bit; and JAX's ``restore`` of it
    gives the saved state."""
    _, jax_out, ranks = runs
    for out in ranks:
        assert bool(out["elastic_dm41"]) and bool(out["elastic_dm14"])
    assert int(jax_out["elastic_step"]) == 1
    for i in range(4 * 14 + 2):
        want = ranks[0][f"elastic_saved{i}"]
        got = jax_out[f"elastic_restored{i}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
