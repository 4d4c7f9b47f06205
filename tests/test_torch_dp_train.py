"""The port's data-parallel train step over a ``torch.distributed``
process group against the JAX package's ``shard_map`` island, at world
size 4 on the CPU.

Every mesh case runs in ONE launch of four gloo processes and ONE JAX
subprocess with four forced host devices, started together, each under
its own timeout (the pattern of ``tests/test_torch_collectives.py``).
Both sides get the same draws: the JAX step draws the signs of leaf i
from ``fold_in(key, 2i)``, the mask of (leaf i, peer p) from
``_leaf_mask(key, i, p, ...)`` and the int8 wire's noise from
``fold_in(key, 3i + 2)``; this file makes those draws with JAX and
hands each rank its own as tensors.  The weights are JAX's, carried
across; the batches come from the same numpy pipeline, rank r taking
``shard_batch(0, r, 4)`` as JAX's dp-sharded ``device_put`` does.

Cases and tolerances, all float32:

(a) the sync functions alone on identical gradients (numpy, from a
    seed): estimates within atol 1e-5 of JAX's ``_sync_grads_celeris``
    / ``_sync_grads_plain_island``, the int8 codes equal to the JAX
    package's expression for them, ``recv_frac`` exact;
(b) one whole step at smoke size on (4,) ``data``, (4, 1) ``data x
    model`` (tiles around the ``model`` dim) and (2, 2) ``pod x data``
    meshes, in every mode: ``tests/test_torch_train.py``'s tolerances
    (loss rtol 1e-5, first moments atol 1e-8, the parameters to the
    first AdamW update's conditioning bound, ``recv_frac`` exact), and
    on the int8 wire the first moments also within one quantization
    step (``chip_smoke.int8_step_bound``), which two frameworks' codes
    can differ by where their gradients straddle a ``floor``; every
    rank bit-identical;
(c) the world-4 exact step against the port's single-device step on
    ``global_batch(0, 4)``: the same tolerances;
(d) the partition specs leaf by leaf against JAX's on the three meshes,
    at smoke and full width;
(e) the median over the group against ``jnp.median`` (even and odd
    counts), and the in-step timeout forms against JAX's, exactly;
(f) the refusals: ``hierarchical`` without ``pod`` (JAX's ValueError);
    a ``model`` axis larger than 1 builds (tensor parallelism, held to
    JAX's step in ``tests/test_torch_tp_train.py``);
(g) ZeRO-1: after a step each rank holds its slice, by JAX's
    ``zero1_specs``, of the whole ``master``, ``mu`` and ``nu`` (gathered
    over ``data``), bit for bit, on every mesh (the step checks of (b)
    and (c) read the moments gathered over ``data``); and AdamW over the
    slices gives bit for bit the replicated update's parameters and the
    slices of its state, on the same bfloat16 leaves and gradients.
"""
import contextlib
import dataclasses
import functools
import json
import logging
import os
import re
import socket
import subprocess
import sys
import textwrap
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as JC
from repro.core import coding as jcoding
from repro.core import timeout as jtimeout
from repro.core.transport.coupling import MAX_DROP
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.train import sharding_rules as jrules
from repro.train import train_step as jts
import chip_smoke
import repro_torch.configs as TC
from repro_torch import sharding as tshd
from repro_torch.core import timeout as ttimeout
from repro_torch.launch import mesh as tmesh
from repro_torch.models import convert as tconvert
from repro_torch.train import train_step as tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = logging.getLogger(__name__)
WORLD, TIMEOUT = 4, 300
MIN_CODED, SEQ, BATCH = 1024, 32, 8
OPT = dict(lr=1e-3, warmup_steps=10, total_steps=500)
MESHES = {"d4": ((4,), ("data",)), "dm41": ((4, 1), ("data", "model")),
          "pd22": ((2, 2), ("pod", "data"))}
# (a): name -> (mesh, kind, quantize_wire, drop, wire dtype); kind
# celeris / plain / hier (exact over data, coded over pod)
SYNC_CASES = {"f32_d05": ("d4", "celeris", False, 0.05, "float32"),
              "bf16_d05": ("d4", "celeris", False, 0.05, "bfloat16"),
              "int8_d0": ("d4", "celeris", True, 0.0, "float32"),
              "int8_d05": ("d4", "celeris", True, 0.05, "float32"),
              "plain_d05": ("d4", "plain", False, 0.05, "float32"),
              "hier_f32": ("pd22", "hier", False, 0.1, "float32"),
              "hier_int8": ("pd22", "hier", True, 0.1, "float32")}
SYNC_ROT = 128
# (leaf shape, sharded dim); None plans the leaf uncoded
SYNC_LEAVES = [((3, 40, 96), 2), ((300, 64), None), ((50,), "uncoded"),
               ((2, 130, 33), None), ((96, 130), 0)]
# (b): name -> (mesh, mode, quantize_wire, drop rate or vector)
STEP_CASES = {"d4_exact": ("d4", "exact", False, 0.0),
              "d4_lossy": ("d4", "lossy", False, 0.1),
              "d4_lh": ("d4", "lossy_hadamard", False, 0.1),
              "d4_lh_int8": ("d4", "lossy_hadamard", True, 0.1),
              "dm41_exact": ("dm41", "exact", False, 0.0),
              "dm41_lossy": ("dm41", "lossy", False, 0.1),
              "dm41_lh": ("dm41", "lossy_hadamard", False, 0.1),
              "dm41_lh_int8": ("dm41", "lossy_hadamard", True, 0.1),
              "pd22_exact": ("pd22", "exact", False, 0.0),
              "pd22_lossy": ("pd22", "lossy", False, 0.1),
              "pd22_lh": ("pd22", "lossy_hadamard", False, 0.1),
              "pd22_hier2": ("pd22", "hierarchical", False, [0.0, 0.1]),
              "pd22_hier3_int8": ("pd22", "hierarchical", True,
                                  [0.02, 0.0, 0.1])}
STEP_KEY = 5
# (g): the cases whose ranks report their ZeRO-1 slices, one a mesh
ZERO_CASES = ("d4_lh", "dm41_lh", "pd22_hier2")
MEDIAN_VALUES = (1.7, 0.4, 2.9, 1.1)

# each side prints "STAGE <name> <seconds>" as it goes; the fixture
# logs those lines, so that a slow run names its slow stage
STAGE = """
import time as _time
_t0 = [_time.time()]
def stage(name):
    now = _time.time()
    print("STAGE %s %.1f" % (name, now - _t0[0]), flush=True)
    _t0[0] = now
"""

# a JAX side's programs: each is traced and lowered in the main thread
# and compiled on a pool, so that XLA compiles them side by side
POOL = """
from concurrent.futures import ThreadPoolExecutor
_pool = ThreadPoolExecutor(4)

def compiled(fn, args):
    return _pool.submit(fn.trace(*args).lower().compile)
"""

JAX_SIDE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import sharding as shd
from repro.core import coding
from repro.optim import adamw
from repro.train import sharding_rules as rules, train_step as ts
d = sys.argv[1]
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
meshes = {k: shd.make_mesh(tuple(v[0]), tuple(v[1]))
          for k, v in meta["meshes"].items()}
out = {}
stage("setup")

# (a) the sync functions on identical gradients, one program for the
# cases that differ only in key and drop rate
plans = [None if sd == "uncoded" else coding.plan_nd(tuple(s), sd,
                                                     meta["sync_rot"])
         for s, sd in meta["sync_leaves"]]
n_leaves = len(plans)
coded = [i for i, p in enumerate(plans) if p is not None]

def sync_program(mesh, kind, q, wire):
    dp = shd.dp_axes(mesh)
    cel = ts.CelerisConfig(mode="lossy_hadamard", quantize_wire=q,
                           wire_dtype=wire)

    def f(peer, key, drop, *gs):
        grads = [g[0] for g in gs]
        pid = peer[0]
        if kind == "hier":
            est, frac = ts._sync_grads_celeris(
                grads, dp, plans, key, drop, cel, mesh, pid // 2,
                lossy_axes=("pod",), exact_axes=("data",))
        elif kind == "plain":
            est, frac = ts._sync_grads_plain_island(grads, dp, plans, key,
                                                    drop, mesh, pid)
        else:
            est, frac = ts._sync_grads_celeris(grads, dp, plans, key, drop,
                                               cel, mesh, pid)
        codes = []
        for i in coded if q else []:
            # the package's int8 wire, train_step.py:170-183
            g, lossy, mp = grads[i], dp, pid
            if kind == "hier":
                g = jax.lax.pmean(g.astype(jnp.float32), ("data",))
                lossy, mp = ("pod",), pid // 2
            plan = plans[i]
            signs = coding.rademacher_nd(jax.random.fold_in(key, 2 * i),
                                         plan)
            tiles = coding.encode_nd(g, signs, plan)
            mask = ts._leaf_mask(key, i, mp, plan.n_rot, drop)
            contrib = tiles * mask[None, :, None].astype(tiles.dtype)
            absmax = jax.lax.pmax(jnp.max(jnp.abs(contrib), axis=(0, 2)),
                                  lossy)
            scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
            noise = jax.random.uniform(jax.random.fold_in(key, 3 * i + 2),
                                       contrib.shape)
            codes.append(jnp.clip(jnp.floor(contrib / scale[None, :, None]
                                            + noise), -127, 127)
                         .astype(jnp.int32)[None])
        return [e[None] for e in est], frac[None], codes

    nc = len(coded) if q else 0
    return jax.jit(shd.shard_map(
        f, mesh=mesh, in_specs=(P(dp), P(), P()) + (P(dp),) * n_leaves,
        out_specs=([P(dp)] * n_leaves, P(dp), [P(dp)] * nc),
        check_vma=False))

grads = [jnp.asarray(inp[f"grad{i}"]) for i in range(n_leaves)]
programs, sync_args = {}, {}
for name, (mk, kind, q, drop, wire) in meta["sync_cases"].items():
    sync_args[name] = (jnp.arange(4, dtype=jnp.int32),
                       jax.random.PRNGKey(meta["sync_keys"][name]),
                       jnp.float32(drop), *grads)
    sig = (mk, kind, q, wire)
    if sig not in programs:
        programs[sig] = compiled(sync_program(meshes[mk], kind, q, wire),
                                 sync_args[name])
for name, (mk, kind, q, drop, wire) in meta["sync_cases"].items():
    est, frac, codes = programs[mk, kind, q, wire].result()(*sync_args[name])
    for i, e in enumerate(est):
        out[f"{name}_est{i}"] = np.asarray(e)
    out[f"{name}_frac"] = np.asarray(frac)
    for j, c in enumerate(codes if q else []):
        out[f"{name}_codes{coded[j]}"] = np.asarray(c)
stage("sync cases")

# (b) whole steps
import repro.configs as C
import dataclasses
from repro.models import model as M
cfg = dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32")
params = M.init_params(jax.random.PRNGKey(0), cfg)
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
steps = {}
for name, (mk, mode, q, drop) in meta["step_cases"].items():
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q)
    step = ts.make_train_step(cfg, meshes[mk], adamw.OptConfig(**meta["opt"]),
                              cel, donate=False)
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "step": jnp.zeros((), jnp.int32)}
    args = (state, batch, jax.random.PRNGKey(meta["step_key"]),
            jnp.asarray(drop, jnp.float32))
    steps[name] = (compiled(step, args), args)
stage("steps traced")
for name, (prog, args) in steps.items():
    new, m = prog.result()(*args)
    for i, (p, mu) in enumerate(zip(jax.tree_util.tree_leaves(new["params"]),
                                    jax.tree_util.tree_leaves(new["opt"]["mu"]))):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = np.asarray(p), np.asarray(mu)
    for k, v in m.items():
        out[f"{name}_m_{k}"] = np.asarray(v)
stage("steps compiled and run")

# (d) the partition specs
specs = {}
isP = lambda x: isinstance(x, P)
for tier, shapes in meta["spec_shapes"].items():
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jax.ShapeDtypeStruct(tuple(s), jnp.float32) for s in shapes])
    for mk, mesh in meshes.items():
        specs[f"{tier}_{mk}_param"] = [list(p) for p in jax.tree_util.tree_leaves(
            rules.param_specs(tree, mesh), is_leaf=isP)]
        specs[f"{tier}_{mk}_zero1"] = [list(p) for p in jax.tree_util.tree_leaves(
            rules.zero1_specs(tree, mesh), is_leaf=isP)]
        specs[f"{tier}_{mk}_batch"] = {k: list(v) for k, v in
                                       rules.batch_specs(mesh, batch).items()}
json.dump(specs, open(d + "/jax_specs.json", "w"))
np.savez(d + "/jax.npz", **out)
stage("specs")
"""

# ZeRO-1 helpers of the torch sides (here and tests/test_torch_tp_train.py):
# ``out``, ``opt`` and ``shd``/``ts``/``adamw`` are the side's own
ZERO_SIDE = """
from chip_smoke import bit_view as bits
from repro_torch.models import convert
from repro_torch.train import sharding_rules as rules

def save_zero(name, new, cfg, mesh):
    # each rank's slices of master, mu, nu and the whole leaves
    specs = rules.opt_state_specs(convert.leaf_shapes(cfg), mesh,
                                  convert.leaf_names(cfg))
    for part in ("master", "mu", "nu"):
        whole = convert.gather_state(new["opt"][part], specs[part], mesh)
        for i, (x, w) in enumerate(zip(new["opt"][part], whole)):
            out[f"{name}_z{part}{i}"] = x.numpy()
            out[f"{name}_w{part}{i}"] = w.numpy()

def zero_vs_replicated(name, cfg, mesh, leaves):
    # AdamW over the ZeRO-1 slices against the replicated update, on the
    # same bfloat16 leaves, state and gradients (the same on every rank)
    step = ts.make_train_step(cfg, mesh, opt)
    tp, zero = step.model_group, step.data_group
    split = [tp is not None and n in tp.split
             for n in convert.short_names(cfg)]
    g = torch.Generator().manual_seed(9)
    leaves = [x.to(torch.bfloat16) for x in leaves]
    grads = [torch.randn(x.shape, generator=g).to(x.dtype) for x in leaves]
    full = adamw.init_opt_state(leaves)
    full["mu"] = [torch.randn(x.shape, generator=g) for x in full["mu"]]
    full["nu"] = [torch.rand(x.shape, generator=g) for x in full["nu"]]
    full["count"] = full["count"] + 3
    mine = {k: v if k == "count" else [adamw.zero_slice(x, zero, i)
                                        for i, x in enumerate(v)]
            for k, v in full.items()}
    p1, s1, _ = adamw.apply_updates(leaves, grads, full, opt, tp, split)
    p2, s2, _ = adamw.apply_updates(leaves, grads, mine, opt, tp, split,
                                    zero)
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip(p1, p2))
    for part in ("master", "mu", "nu"):
        same &= all(torch.equal(bits(adamw.zero_slice(a, zero, i)), bits(b))
                    for i, (a, b) in enumerate(zip(s1[part], s2[part])))
    out[f"zero_same_{name}"] = np.bool_(same)
    out[f"zero_sliced_{name}"] = np.int64(sum(
        d is not None for d in (zero.dims if zero else ())))
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
from repro_torch.core import coding, timeout
from repro_torch.data import pipeline
from repro_torch.optim import adamw
from repro_torch.train import sharding_rules as rules, train_step as ts
inp = np.load(d + "/torch_inputs.npz")
meta = json.load(open(d + "/meta.json"))
t = lambda a: torch.as_tensor(np.array(a))
meshes = {k: shd.make_mesh(tuple(v[0]), tuple(v[1]), "cpu")
          for k, v in meta["meshes"].items()}
out = {}
stage("setup")

def axes(mesh, names):
    return ts._Axes(shd.group(mesh, names), shd.axis_size(mesh, names),
                    shd.peer_index(mesh, names))

# (a) the sync functions on identical gradients
plans = [None if sd == "uncoded" else coding.plan_nd(tuple(s), sd,
                                                     meta["sync_rot"])
         for s, sd in meta["sync_leaves"]]
grads = [t(inp[f"grad{i}"][rank]) for i in range(len(plans))]
dp4 = axes(meshes["d4"], ("data",))
pd = axes(meshes["pd22"], ("pod", "data"))
pod, data = axes(meshes["pd22"], ("pod",)), axes(meshes["pd22"], ("data",))
for name, (mk, kind, q, drop, wire) in meta["sync_cases"].items():
    coded = [i for i, p in enumerate(plans) if p is not None]
    masks = {i: t(inp[f"{name}_mask{i}"][rank]) for i in coded}
    signs = {i: t(inp[f"{name}_signs{i}"]) for i in coded}
    noise = {i: t(inp[f"{name}_noise{i}"]) for i in coded}
    cel = ts.CelerisConfig(mode="lossy_hadamard", quantize_wire=q,
                           wire_dtype=wire)
    if kind == "hier":
        est, frac = ts._sync_grads_celeris(grads, plans, masks, signs,
                                           lambda i, s: noise[i], cel, pd,
                                           pod, data)
        lossy, exact = pod, data
    elif kind == "plain":
        est, frac = ts._sync_grads_plain_island(grads, plans, masks, dp4)
    else:
        est, frac = ts._sync_grads_celeris(grads, plans, masks, signs,
                                           lambda i, s: noise[i], cel, dp4,
                                           dp4)
        lossy, exact = dp4, None
    for i, e in enumerate(est):
        out[f"{name}_est{i}"] = e.numpy()
    out[f"{name}_frac"] = frac.numpy()
    for i in coded if q else []:
        g = grads[i] if exact is None else ts._pmean(grads[i], exact)
        contrib = coding.encode_nd(g, signs[i], plans[i]) * masks[i][
            None, :, None].float()
        out[f"{name}_codes{i}"] = ts._int8_wire(contrib, noise[i],
                                                lossy)[0].numpy()

stage("sync cases")
# (b) whole steps, (c) the single-device exact step
cfg = dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32")
leaves = [t(inp[f"leaf{i}"]) for i in range(14)]
src = pipeline.make_source(pipeline.DataConfig(
    vocab_size=cfg.vocab_size, seq_len=meta["seq"],
    global_batch=meta["batch"], seed=1))
opt = adamw.OptConfig(**meta["opt"])

def save(name, new, m, dg=None):
    mu = chip_smoke.over_data(new, dg)["opt"]["mu"]
    for i, (p, u) in enumerate(zip(new["params"], mu)):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = p.numpy(), u.numpy()
    for k, v in m.items():
        out[f"{name}_m_{k}"] = v.numpy()

for name, (mk, mode, q, drop) in meta["step_cases"].items():
    mesh = meshes[mk]
    dp = shd.dp_axes(mesh)
    peer = shd.peer_index(mesh, dp)
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in src.shard_batch(0, peer, 4).items()}
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q)
    step = ts.make_train_step(cfg, mesh, opt, cel)
    coded = [int(k[len(name) + 5:]) for k in inp.files
             if k.startswith(name + "_mask")]
    masks = {i: t(inp[f"{name}_mask{i}"][rank]) for i in coded}
    signs = {i: t(inp[f"{name}_signs{i}"]) for i in coded}
    noise = {i: t(inp[f"{name}_noise{i}"]) for i in coded
             if f"{name}_noise{i}" in inp.files}
    new, m = step(ts.state_from_params(leaves, cfg, mesh), batch, None,
                  drop, masks=masks, signs=signs, noise=noise)
    save(name, new, m, step.data_group)
    if name in meta["zero_cases"]:
        save_zero(name, new, cfg, mesh)
    if q:
        plans = ts.plan_leaves([l.shape for l in leaves], mesh, cel,
                               convert.leaf_names(cfg))
        if mode == "hierarchical":
            lossy, exact = axes(mesh, ("pod",)), axes(mesh, ("data",))
        else:
            lossy, exact = axes(mesh, dp), None
        bound = chip_smoke.int8_step_bound(cfg, leaves, batch, plans, masks,
                                           signs, lossy, exact)
        for i, b in bound.items():
            out[f"{name}_bound{i}"] = np.float64(b)
    stage("step " + name)
if rank == 0:
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in src.global_batch(0, 4).items()}
    new, m = ts.make_train_step(cfg, None, opt)(
        ts.state_from_params(leaves, cfg), batch, None, 0.0)
    save("single_exact", new, m)
stage("single exact")
for mk, mesh in meshes.items():
    zero_vs_replicated(mk, cfg, mesh, leaves)
stage("zero1 vs replicated")

# chip_smoke's check of the syncs at drop 0 against the exact pmean
zero = chip_smoke.dp_check_coded_syncs(
    torch.device("cpu"), {"host": meshes["dm41"], "pods": meshes["pd22"]},
    cfg, meta["min_coded"])
out.update({f"zero_{k}": np.float64(v) for k, v in zero.items()})
stage("coded syncs at drop 0")

# (d) the partition specs
if rank == 0:
    specs = {}
    for tier, shapes in meta["spec_shapes"].items():
        for mk, mesh in meshes.items():
            names = convert.leaf_names(cfg)
            specs[f"{tier}_{mk}_param"] = rules.param_specs(shapes, mesh,
                                                            names)
            specs[f"{tier}_{mk}_zero1"] = rules.zero1_specs(shapes, mesh,
                                                            names)
            specs[f"{tier}_{mk}_batch"] = rules.batch_specs(
                mesh, {"tokens": np.zeros((8, 32)), "labels": np.zeros((8, 32))})
    json.dump(specs, open(d + "/torch_specs.json", "w"))

# (e) the median over the group: four ranks, and three
local = torch.tensor(meta["median_values"][rank], dtype=torch.float32)
out["median4"] = timeout.coordinate_group(local).numpy()
three = dist.new_group([0, 1, 2])
if rank < 3:
    out["median3"] = timeout.coordinate_group(local, three).numpy()
np.savez(d + "/rank%d.npz" % rank, **out)
dist.destroy_process_group()
"""


def _torch_side(code):
    """A torch side's script with the ZeRO-1 helpers defined after its
    setup (the line ``opt = adamw.OptConfig(**meta["opt"])``), and
    ``stage`` before it."""
    head, sep, tail = textwrap.dedent(code).partition(
        'opt = adamw.OptConfig(**meta["opt"])\n')
    assert sep, "the torch side defines no opt"
    return textwrap.dedent(STAGE) + head + sep + ZERO_SIDE + tail


def jax_side(code):
    """A JAX side's script with ``stage`` and ``compiled`` before it."""
    return textwrap.dedent(STAGE) + textwrap.dedent(POOL) + textwrap.dedent(
        code)


def run_sides(d, jax_code, torch_code, env, timeout=TIMEOUT, prepare=None):
    """Start the JAX side, run ``prepare`` (the torch ranks' inputs)
    meanwhile, then start the four torch ranks; wait for each process
    under ``timeout`` and log its wall and its STAGE lines; raise with
    the logs of those that failed."""
    t0 = time.perf_counter()
    procs = [("jax", subprocess.Popen(
        [sys.executable, "-c", jax_code, d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))]
    try:
        if prepare is not None:
            prepare()
    except BaseException:
        procs[0][1].kill()
        procs[0][1].communicate()
        raise
    port = str(_free_port())
    procs += [(f"rank{r}", subprocess.Popen(
        [sys.executable, "-c", torch_code, str(r), port, d],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for r in range(WORLD)]
    failed = []
    try:
        for name, p in procs:
            log, _ = p.communicate(timeout=timeout)
            LOG.info("%s: exit %s after %.1f s; %s", name, p.returncode,
                     time.perf_counter() - t0,
                     "; ".join(l[6:] for l in log.splitlines()
                               if l.startswith("STAGE ")))
            if p.returncode != 0:
                failed.append(log)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cfg():
    return dataclasses.replace(JC.get_smoke("qwen2-0.5b"), dtype="float32")


def _stub_mesh(mk):
    """JAX's ``param_specs`` reads only ``mesh.shape``."""
    shape, names = MESHES[mk]
    return types.SimpleNamespace(shape=dict(zip(names, shape)))


def _mask_peers(mk, mode, drop):
    """(mask peer of each rank, the rate of each mask peer) as the JAX
    island computes them: the dp index at ``drop``, or in hierarchical
    mode the pod index at its pod's float32 combined rate."""
    if mode != "hierarchical":
        return list(range(WORLD)), [jnp.float32(drop)] * WORLD
    dr = jnp.reshape(jnp.asarray(drop, jnp.float32), (-1,))
    cross = dr[-1]
    rates = [cross, cross]
    if dr.shape[0] == 3:
        rates = [jnp.minimum(1.0 - (1.0 - dr[p]) * (1.0 - cross), MAX_DROP)
                 for p in range(2)]
    return [r // 2 for r in range(WORLD)], rates


def _draws(key, i, plan, peers, rates, noise):
    """JAX's draws for leaf i: each rank's mask, the signs, the noise."""
    masks = np.stack([np.asarray(jts._leaf_mask(key, i, p, plan.n_rot,
                                                rates[p])) for p in peers])
    signs = np.asarray(jcoding.rademacher_nd(jax.random.fold_in(key, 2 * i),
                                             plan))
    out = {"mask": masks, "signs": signs}
    if noise:
        ns = plan.shape[plan.sharded_dim] if plan.sharded_dim is not None \
            else 1
        out["noise"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(key, 3 * i + 2), (plan.tiles, plan.n_rot, ns)))
    return out


def jax_inputs(d):
    """Write the JAX side's inputs (``inputs.npz``: each rank's sync
    gradients and the batch) and the cases (``meta.json``) into ``d``;
    return the inputs and the cases."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    inp = {}
    for i, (shape, _) in enumerate(SYNC_LEAVES):
        inp[f"grad{i}"] = rng.standard_normal((WORLD,) + shape).astype(
            np.float32)
    jcfg = _cfg()
    src = jpipe.make_source(jpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=1))
    inp.update(src.global_batch(0, WORLD))
    spec_shapes = {tier: [list(l.shape) for l in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda k, c=c: JM.init_params(k, c),
                       jax.random.PRNGKey(0)))]
        for tier, c in (("smoke", jcfg), ("full", JC.get("qwen2-0.5b")))}
    meta = {"meshes": MESHES, "sync_cases": SYNC_CASES,
            "sync_leaves": SYNC_LEAVES, "sync_rot": SYNC_ROT,
            "sync_keys": {name: 10 + n for n, name in enumerate(SYNC_CASES)},
            "step_cases": STEP_CASES, "step_key": STEP_KEY,
            "min_coded": MIN_CODED, "opt": OPT, "seq": SEQ, "batch": BATCH,
            "spec_shapes": spec_shapes, "median_values": MEDIAN_VALUES,
            "zero_cases": ZERO_CASES}
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    LOG.info("prep: the JAX side's inputs (eval_shape of both tiers) "
             "after %.1f s", time.perf_counter() - t0)
    return inp, meta


def torch_inputs(d, inp, meta):
    """Add the weights and JAX's draws of every case to ``inp`` and write
    it as the torch ranks' inputs (``torch_inputs.npz``).  The JAX side
    makes the same draws inside its programs."""
    t0 = time.perf_counter()
    # (a) JAX's draws for each rank's sync
    for name, (mk, kind, q, drop, _) in SYNC_CASES.items():
        key = jax.random.PRNGKey(meta["sync_keys"][name])
        peers = [r // 2 for r in range(WORLD)] if kind == "hier" \
            else list(range(WORLD))
        for i, (shape, sd) in enumerate(SYNC_LEAVES):
            if sd == "uncoded":
                continue
            plan = jcoding.plan_nd(shape, sd, SYNC_ROT)
            for k, v in _draws(key, i, plan, peers, [drop] * WORLD,
                               True).items():
                inp[f"{name}_{k}{i}"] = v
    LOG.info("prep: the sync cases' draws after %.1f s",
             time.perf_counter() - t0)
    # (b) the weights and each step's draws
    jparams = JM.init_params(jax.random.PRNGKey(0), _cfg())
    jleaves = jax.tree_util.tree_leaves(jparams)
    for i, leaf in enumerate(jleaves):
        inp[f"leaf{i}"] = np.asarray(leaf)
    LOG.info("prep: init_params after %.1f s", time.perf_counter() - t0)
    key = jax.random.PRNGKey(STEP_KEY)
    for name, (mk, mode, q, drop) in STEP_CASES.items():
        if mode == "exact":
            continue
        specs = jax.tree_util.tree_leaves(
            jrules.param_specs(jparams, _stub_mesh(mk)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        peers, rates = _mask_peers(mk, mode, drop)
        for i, (leaf, spec) in enumerate(zip(jleaves, specs)):
            if leaf.size < MIN_CODED:
                continue
            sd = next((j for j, s in enumerate(spec) if s == "model"), None)
            plan = jcoding.plan_nd(leaf.shape, sd, 4096)
            for k, v in _draws(key, i, plan, peers, rates, q).items():
                inp[f"{name}_{k}{i}"] = v
    np.savez(os.path.join(d, "torch_inputs.npz"), **inp)
    LOG.info("prep: the weights and the steps' draws written after %.1f s",
             time.perf_counter() - t0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch: the JAX side starts on its inputs while this process
    makes the torch ranks' (JAX's draws), then the four ranks start."""
    d = str(tmp_path_factory.mktemp("dp_train"))
    inp, meta = jax_inputs(d)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]), OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run_sides(d, jax_side(JAX_SIDE), _torch_side(TORCH_SIDE), env,
              prepare=lambda: torch_inputs(d, inp, meta))
    load = functools.partial(np.load, allow_pickle=False)
    with open(os.path.join(d, "jax_specs.json")) as f:
        jspecs = json.load(f)
    with open(os.path.join(d, "torch_specs.json")) as f:
        tspecs = json.load(f)
    return (inp, dict(load(os.path.join(d, "jax.npz"))),
            [dict(load(os.path.join(d, f"rank{r}.npz")))
             for r in range(WORLD)], jspecs, tspecs)


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_matches_jax_island(runs, case):
    inp, jax_out, ranks, _, _ = runs
    _, _, q, drop, wire = SYNC_CASES[case]
    for r, out in enumerate(ranks):
        for i in range(len(SYNC_LEAVES)):
            got, want = out[f"{case}_est{i}"], jax_out[f"{case}_est{i}"][r]
            if wire == "float32":
                np.testing.assert_allclose(got, want, atol=1e-5)
            else:
                # both sides round each peer's contribution to bfloat16 and
                # sum in bfloat16, in their own order: within a few of its
                # rounding steps (2^-8 relative) of each other in norm
                assert np.linalg.norm(got - want) <= 2 ** -6 * np.linalg.norm(
                    want), (case, i)
        assert float(out[f"{case}_frac"]) == float(
            jax_out[f"{case}_frac"][r])
        for i, (_, sd) in enumerate(SYNC_LEAVES):
            if q and sd != "uncoded":
                np.testing.assert_array_equal(out[f"{case}_codes{i}"],
                                              jax_out[f"{case}_codes{i}"][r])
    frac = float(ranks[0][f"{case}_frac"])
    if drop == 0.0:
        assert frac == 1.0
        # the int8 wire at drop 0 is the mean within quantization noise
        want = inp["grad0"].mean(0)
        err = np.linalg.norm(ranks[0][f"{case}_est0"] - want)
        assert err < 0.05 * np.linalg.norm(want), err
    else:
        assert abs(frac - (1 - drop)) < 0.04, frac
    # every rank holds one result
    for out in ranks[1:]:
        for i in range(len(SYNC_LEAVES)):
            np.testing.assert_array_equal(out[f"{case}_est{i}"],
                                          ranks[0][f"{case}_est{i}"])


@pytest.mark.parametrize("cell", [c[0] for c in chip_smoke.DP_ZERO_CELLS])
def test_syncs_at_drop_0_hold_to_the_exact_pmean(runs, cell):
    """``chip_smoke.dp_check_coded_syncs`` (the card's full-width check)
    on the four CPU ranks at smoke size: it raises past its tolerance,
    and reports each cell's worst error against it."""
    *_, ranks, _, _ = runs
    for out in ranks:
        assert 0.0 <= float(out[f"zero_{cell}"]) <= 1.0


def _check_step(got, want, name, bounds=None):
    """``tests/test_torch_train.py``'s tolerances; ``bounds`` (int8) adds
    one quantization step of each coded leaf's gradient to its first
    moment's tolerance, and the parameters' bound takes the update
    difference whole, since a step can move a gradient near 0 across
    eps."""
    eps, lr, b1 = 1e-8, OPT["lr"], 0.9
    for i in range(14):
        mu, want_mu = got[f"{name}_mu{i}"], want[f"{name}_mu{i}"]
        atol = 1e-8 + (1 - b1) * (bounds or {}).get(i, 0.0)
        np.testing.assert_allclose(mu, want_mu, atol=atol,
                                   err_msg=f"{name} leaf {i}")
        # the first update is lr * g / (|g| + eps): twice the difference
        # the two sides' own gradients explain (for a small difference,
        # the slope bound 2 lr eps |dg| / (|g| + eps)^2)
        g, g_want = (m.astype(np.float64) / (1 - b1) for m in (mu, want_mu))
        bound = 1e-7 + 2 * lr * np.abs(g / (np.abs(g) + eps)
                                       - g_want / (np.abs(g_want) + eps))
        assert np.all(np.abs(got[f"{name}_p{i}"] - want[f"{name}_p{i}"])
                      <= bound), (name, i)


def _case(out, case, kinds="p|mu|m_"):
    """The entries of one step case: ``<case>_p<i>``, ``_mu<i>``,
    ``_m_<metric>`` (or ``_bound<i>``), not those of a case whose name
    it prefixes."""
    return {k: v for k, v in out.items()
            if re.fullmatch(rf"{re.escape(case)}_({kinds})\w+", k)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dp_step_matches_jax(runs, case):
    _, jax_out, ranks, _, _ = runs
    mk, mode, q, drop = STEP_CASES[case]
    want = _case(jax_out, case)
    for out in ranks:
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
    # every rank ends the step bit-identical
    for out in ranks[1:]:
        for k, v in _case(ranks[0], case).items():
            np.testing.assert_array_equal(out[k], v, err_msg=k)
    frac = float(ranks[0][f"{case}_m_recv_frac"])
    if mode == "exact":
        assert frac == 1.0
    else:
        assert frac < 1.0


def test_dp_exact_equals_one_device_on_the_global_batch(runs):
    _, _, ranks, _, _ = runs
    single = {k.replace("single_exact", "d4_exact"): v
              for k, v in ranks[0].items() if k.startswith("single_exact")}
    np.testing.assert_allclose(float(ranks[0]["d4_exact_m_loss"]),
                               float(single["d4_exact_m_loss"]), rtol=1e-5)
    _check_step(ranks[0], single, "d4_exact")


@pytest.mark.parametrize("tier", ["smoke", "full"])
@pytest.mark.parametrize("mk", list(MESHES))
def test_partition_specs_match_jax(runs, tier, mk):
    *_, jspecs, tspecs = runs
    for kind in ("param", "zero1", "batch"):
        key = f"{tier}_{mk}_{kind}"
        assert tspecs[key] == jspecs[key], key
    if mk == "dm41":    # a model axis of 1 still names the model dim
        assert any("model" in s for s in tspecs[f"{tier}_{mk}_param"])


def test_median_over_the_group_is_jnp_median(runs):
    _, _, ranks, _, _ = runs
    want4 = np.float32(jnp.median(jnp.asarray(MEDIAN_VALUES, jnp.float32)))
    want3 = np.float32(jnp.median(jnp.asarray(MEDIAN_VALUES[:3],
                                              jnp.float32)))
    assert want4 == np.float32((np.float32(1.1) + np.float32(1.7)) * 0.5)
    for r, out in enumerate(ranks):
        assert out["median4"] == want4
        if r < 3:
            assert out["median3"] == want3 == np.float32(1.7)


def test_in_step_timeout_forms_match_jax():
    rng = np.random.default_rng(2)
    for cfg in (dict(), dict(init_timeout=2.0, min_timeout=0.5,
                             max_timeout=8.0)):
        jc, tc = jtimeout.TimeoutConfig(**cfg), ttimeout.TimeoutConfig(**cfg)
        np.testing.assert_array_equal(ttimeout.init_tensor(tc).numpy(),
                                      np.asarray(jtimeout.init_jax(jc)))
        js, ts_ = jtimeout.init_jax(jc), ttimeout.init_tensor(tc)
        for _ in range(40):
            dur = np.float32(rng.uniform(0.001, 4.0))
            frac = np.float32(rng.choice([1.0, 0.97, 0.5, 0.0,
                                          rng.uniform()]))
            js = jtimeout.update_jax(js, jnp.float32(dur), jnp.float32(frac),
                                     jc)
            ts_ = ttimeout.update_tensor(ts_, torch.tensor(dur),
                                         torch.tensor(frac), tc)
            np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))


@contextlib.contextmanager
def fake_world(n=WORLD):
    """A ``fake`` process group of ``n`` ranks in this process (no
    collective runs): enough to build meshes and steps and see them
    refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dp_refusals_match_jax():
    tcfg = TC.get_smoke("qwen2-0.5b")
    with fake_world():
        data = tmesh.make_host_mesh((4,), ("data",), device_type="cpu")
        with pytest.raises(ValueError, match="needs a 'pod' mesh axis"):
            tts.make_train_step(tcfg, data, None,
                                tts.CelerisConfig(mode="hierarchical"))
        tp = tmesh.make_host_mesh((2, 2), device_type="cpu")
        assert tts.make_train_step(tcfg, tp).model_group.size == 2
        with pytest.raises(ValueError, match="needs 8 ranks"):
            tmesh.make_host_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="n_pods=1"):
            tmesh.make_pod_mesh(1, 2, 2, device_type="cpu")
        pods = tmesh.make_pod_mesh(2, 2, 1, device_type="cpu")
        assert pods.mesh_dim_names == ("pod", "data", "model")
        tts.make_train_step(tcfg, pods, None,
                            tts.CelerisConfig(mode="hierarchical"))


@pytest.mark.parametrize("vector", [[0.0, 0.1], [0.02, 0.0, 0.1],
                                    [0.6, 0.0, 0.3], [0.05]])
def test_pod_rates_match_the_jax_island(vector):
    """Each pod's mask rate, float32, as the JAX island computes it for
    its pod: the cross component, or with a (n_pods + 1,) vector the
    combined rate capped at MAX_DROP."""
    _, want = _mask_peers("pd22", "hierarchical", vector)
    got = tts._pod_rates(vector, 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want, np.float32))
    if vector == [0.6, 0.0, 0.3]:
        assert float(got[0]) == MAX_DROP


def test_mesh_draws_are_each_peers_row_of_one_draw():
    """Every rank draws all mask peers' masks from the same generator and
    keeps its own row; the signs follow, the same on every rank."""
    from repro_torch.core import coding as tcoding
    plans = [tcoding.plan_nd((64, 32), None, 512), None,
             tcoding.plan_nd((3, 40, 96), 2, 128)]
    rates = torch.tensor([0.1, 0.3, 0.5, 0.0])
    got = [tts._draw_dp(torch.Generator().manual_seed(4), plans, rates, p,
                        True, None, None, "cpu") for p in range(4)]
    g = torch.Generator().manual_seed(4)
    rows = {i: torch.rand((4, plans[i].n_rot), generator=g)
            >= rates[:, None] for i in (0, 2)}
    signs = {i: tcoding.rademacher_nd(g, plans[i]) for i in (0, 2)}
    for p, (masks, sg) in enumerate(got):
        assert sorted(masks) == sorted(sg) == [0, 2]
        for i in (0, 2):
            assert torch.equal(masks[i], rows[i][p])
            assert torch.equal(sg[i], signs[i])
    assert not torch.equal(got[0][0][0], got[1][0][0])
    assert bool(got[3][0][0].all())           # rate 0 drops nothing


def test_launcher_trains_on_four_cpu_ranks(tmp_path):
    """``launch/train.py --mesh host`` under ``torch.distributed.run``:
    gloo on the CPU, JAX's host mesh (2, 2) over (data, model), rank 0
    reporting each step and writing a checkpoint each step, of the whole
    leaves (the ranks hold their model shards of ZeRO-1 slices)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--arch", "qwen2-0.5b", "--smoke",
         "--device", "cpu", "--mesh", "host", "--celeris", "--steps", "2",
         "--seq-len", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
         "1"], env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stdout + run.stderr
    assert (tmp_path / "LATEST").read_text() == "2"
    with open(tmp_path / "step_2" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["extra"]["arch"] == "qwen2-0.5b-smoke"
    shapes = [m["shape"] for m in manifest["leaves"]]
    want = [list(s) for s in tconvert.leaf_shapes(TC.get_smoke("qwen2-0.5b"))]
    assert shapes == [[]] + want * 4 + [[]]
    assert "backend gloo, 4 ranks, rank 0 on cpu" in run.stdout
    steps = [l for l in run.stdout.splitlines() if l.startswith("step ")]
    recv = [float(l.split("recv ")[1].split()[0]) for l in steps]
    assert len(steps) == 2 and all(0.4 <= f <= 1.0 for f in recv), steps


def test_global_mesh_registry_matches_jax():
    """``dp_axes()`` without a mesh reads the registered one, as JAX's."""
    from repro import sharding as jshd
    assert tshd.dp_axes() == jshd.dp_axes() == ()
    with fake_world():
        for shape, names in (((4, 1), ("data", "model")),
                             ((2, 2, 1), ("pod", "data", "model"))):
            tshd.set_global_mesh(tshd.make_mesh(shape, names, "cpu"))
            jshd.set_global_mesh(jshd.make_mesh((1,) * len(shape), names))
            try:
                assert tshd.get_global_mesh().mesh_dim_names == names
                assert tshd.dp_axes() == jshd.dp_axes()
                assert tshd.dp_axes() == tuple(n for n in names
                                               if n != "model")
            finally:
                tshd.set_global_mesh(None)
                jshd.set_global_mesh(None)


@pytest.mark.parametrize("n,shape", [(256, (16, 16)), (512, (2, 16, 16)),
                                     (1024, (4, 16, 16)), (768, None),
                                     (300, None)])
def test_scale_mesh_shapes(n, shape):
    """``make_scale_mesh``: JAX's shapes and axis names; a size that is
    not 256 or a multiple of 256 >= 512 raises JAX's ValueError."""
    with fake_world(n):
        if n == 768:        # a multiple of 256 >= 512: three pods
            shape = (3, 16, 16)
        if shape is None:
            with pytest.raises(ValueError, match="must be 256 or a multiple"):
                tmesh.make_scale_mesh(n, device_type="cpu")
            return
        mesh = tmesh.make_scale_mesh(n, device_type="cpu")
        assert tuple(mesh.mesh.shape) == shape
        assert mesh.mesh_dim_names == (("data", "model") if n == 256
                                       else ("pod", "data", "model"))


@pytest.mark.parametrize("mk", ["none", "host", "pods"])
def test_chip_smoke_fwht_shapes_are_the_train_paths(mk):
    """``chip_smoke``'s FWHT shapes for the train paths are those the
    coded step rotates at full width: one device's (24 layers), and on
    the dp meshes' (4, 1) and (2, 2, 1), where tiles form around the
    model dim, at phase 6b's depth (``chip_smoke.MESH_LAYERS``) as
    ``check_train_shapes`` computes them."""
    jcfg = JC.get("qwen2-0.5b")
    if mk != "none":
        jcfg = dataclasses.replace(jcfg, n_layers=chip_smoke.MESH_LAYERS)
    shapes = [l.shape for l in jax.tree_util.tree_leaves(jax.eval_shape(
        lambda k: JM.init_params(k, jcfg), jax.random.PRNGKey(0)))]
    with fake_world():
        mesh = {"none": lambda: None,
                "host": lambda: tmesh.make_host_mesh((4, 1), device_type="cpu"),
                "pods": lambda: tmesh.make_pod_mesh(2, 2, 1,
                                                    device_type="cpu")}[mk]()
        plans = [p for p in tts.plan_leaves(
            shapes, mesh, tts.CelerisConfig(mode="lossy_hadamard"),
            tconvert.leaf_names(TC.get("qwen2-0.5b"))) if p is not None]
    got = sorted({(p.tiles * (p.shape[p.sharded_dim]
                              if p.sharded_dim is not None else 1), p.n_rot)
                  for p in plans})
    assert len(plans) == chip_smoke.CODED_LEAVES
    if mk == "none":
        want = [(r, 4096) for r in chip_smoke.TRAIN_FWHT_ROWS]
    else:
        want = chip_smoke.tp_fwht_shapes(
            dataclasses.replace(TC.get("qwen2-0.5b"),
                                n_layers=chip_smoke.MESH_LAYERS),
            chip_smoke.mesh_shape((4, 1), ("data", "model")))
    assert got == sorted(set(want))
    if mk != "none":
        assert got == [(256, 1024), (2048, 1024), (9728, 1024),
                       (303872, 512)]



def zero1_blocks(ranks, case, shape, names, specs):
    """Hold each rank's ZeRO-1 slices of ``case`` to its block, by the
    partition ``specs`` (JAX's ``zero1_specs``, leaf by leaf), of the
    whole leaves it reported (gathered over ``data`` and ``model``), bit
    for bit, on a mesh of ``shape`` over ``names``; every rank reports the
    same whole leaves.  Returns the number of leaves split over a
    ``data`` axis larger than 1."""
    size = dict(zip(names, shape))
    for r, out in enumerate(ranks):
        coord = dict(zip(names, np.unravel_index(r, shape)))
        for part in ("master", "mu", "nu"):
            for i, spec in enumerate(specs):
                whole = out[f"{case}_w{part}{i}"]
                np.testing.assert_array_equal(whole,
                                              ranks[0][f"{case}_w{part}{i}"])
                index = tuple(
                    slice(None) if a is None else
                    slice(coord[a] * (n // size[a]),
                          (coord[a] + 1) * (n // size[a]))
                    for a, n in zip(spec, whole.shape))
                np.testing.assert_array_equal(out[f"{case}_z{part}{i}"],
                                              whole[index],
                                              err_msg=f"{case} {part} {i}")
    return sum("data" in spec and size.get("data", 1) > 1 for spec in specs)


def _jax_zero1_specs(mk, cfg):
    """JAX's ZeRO-1 specs of ``cfg``'s leaves on mesh ``mk`` (stubbed)."""
    jparams = JM.init_params(jax.random.PRNGKey(0), cfg)
    return [tuple(p) for p in jax.tree_util.tree_leaves(
        jrules.zero1_specs(jparams, _stub_mesh(mk)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("case", ZERO_CASES)
def test_each_rank_holds_its_zero1_slices(runs, case):
    *_, ranks, _, _ = runs
    mk = STEP_CASES[case][0]
    n_split = zero1_blocks(ranks, case, *MESHES[mk],
                           _jax_zero1_specs(mk, _cfg()))
    # the port's data group splits the leaves JAX's specs split: all
    # but those with no free dim the data axis divides
    assert n_split == int(ranks[0][f"zero_sliced_{mk}"]) >= 11
    # the whole moments are the step's, which (b) holds to JAX's
    for i in range(14):
        np.testing.assert_array_equal(ranks[0][f"{case}_wmu{i}"],
                                      ranks[0][f"{case}_mu{i}"])


@pytest.mark.parametrize("mk", list(MESHES))
def test_zero1_update_is_the_replicated_update(runs, mk):
    *_, ranks, _, _ = runs
    for out in ranks:
        assert bool(out[f"zero_same_{mk}"])
        assert int(out[f"zero_sliced_{mk}"]) >= 11
