"""Training the recurrent families and the modality stubs on a (4, 1)
data x model mesh with ZeRO-1: the port's step against the JAX
package's step on the same mesh, at world size 4 on the CPU, float32 at
smoke widths.

Every case runs in ONE launch of four gloo processes and ONE JAX
subprocess with four forced host devices, started together, each under
its own timeout (the pattern of ``tests/test_torch_train_families_mesh.
py``).  Both sides start from JAX's weights (PRNGKey 0) and take the JAX
pipeline's global batch of 8 rows, rank r its dp index's rows, a stub's
extras (float32 from a numpy seed, ``test_torch_train_recurrent.
make_batch``) split by rows with the tokens; the coded cases get JAX's
masks (each rank its dp peer's) and signs.  Cases:

- xlstm-350m ``lossy_hadamard`` at drop 0.1 (the stacked 4-D sLSTM
  ``r_h`` and the float32 ``w_if``/``b_if`` coded or synced exactly);
- seamless-m4t-medium ``exact`` with its frames (the encoder stack and the
  cross-attention in the backward);
- phi-3-vision-4.2b ``lossy_hadamard`` at drop 0.1 with its image embeds.

Each rank's loss, nll and grad norm against JAX's (rtol 1e-5),
``recv_frac`` to 1e-7, every parameter and first moment at
``tests/test_torch_train.py``'s tolerances, the four ranks bit-identical;
then each rank's ZeRO-1 slices of ``master``, ``mu`` and ``nu`` are its
blocks, by JAX's ``zero1_specs``, of the whole state, bit for bit.
"""
import functools
import json
import os
import textwrap

import jax
import numpy as np
import pytest

from repro.core import coding as jcoding
from repro.models import model as JM
from repro.train import sharding_rules as jrules
import test_torch_dp_train as dp_train
from test_torch_dp_train import _case, _draws, _torch_side, zero1_blocks
from test_torch_tp_train import MESHES, _mask_rows, _stub_mesh
from test_torch_train_families import MIN_CODED, OPT, _cfgs
from test_torch_train_families_mesh import _check_step
from test_torch_train_recurrent import make_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, TIMEOUT = 4, 300
SEQ, BATCH, STEP_KEY = 32, 8, 7
# name -> (arch, mesh, mode, quantize_wire, drop)
CASES = {"xlstm_dm41_lh": ("xlstm-350m", "dm41", "lossy_hadamard", False,
                           0.1),
         "seamless_dm41_exact": ("seamless-m4t-medium", "dm41", "exact",
                                 False, 0.0),
         "phi3_dm41_lh": ("phi-3-vision-4.2b", "dm41", "lossy_hadamard",
                          False, 0.1)}
EXTRAS = ("seamless_dm41_exact", "phi3_dm41_lh")

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
out = {}
stage("setup")
# every step is traced under its mesh here and compiled on the pool
steps = {}
for name, (arch, mk, mode, q, drop, *kw) in meta["cases"].items():
    if name in meta["torch_only"]:
        continue
    mesh = shd.make_mesh(*map(tuple, meta["meshes"][mk]))
    shd.set_global_mesh(mesh)
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32",
                              **(kw[0] if kw else {}))
    p = M.init_params(jax.random.PRNGKey(0), cfg)
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q)
    step = ts.make_train_step(cfg, mesh, adamw.OptConfig(**meta["opt"]),
                              cel, donate=False)
    state = {"params": p, "opt": adamw.init_opt_state(p),
             "step": jnp.zeros((), jnp.int32)}
    batch = {k[len(name) + 7:]: jnp.asarray(inp[k]) for k in inp.files
             if k.startswith(name + "_batch_")}
    args = (state, batch, jax.random.PRNGKey(meta["step_key"]),
            jnp.asarray(drop, jnp.float32))
    steps[name] = (compiled(step, args), args)
stage("traced")
for name, (prog, args) in steps.items():
    new, m = prog.result()(*args)
    leaves = jax.tree_util.tree_leaves
    for i, (w, mu) in enumerate(zip(leaves(new["params"]),
                                    leaves(new["opt"]["mu"]))):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = (np.asarray(w),
                                                     np.asarray(mu))
    for key, v in m.items():
        out[f"{name}_m_{key}"] = np.asarray(v)
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
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
t = lambda a: torch.as_tensor(np.array(a))
opt = adamw.OptConfig(**meta["opt"])
out = {}
for name, (arch, mk, mode, q, drop, *kw) in meta["cases"].items():
    mesh = shd.make_mesh(*map(tuple, meta["meshes"][mk]), "cpu")
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32",
                              **(kw[0] if kw else {}))
    names = convert.leaf_names(cfg)
    leaves = convert.shard_leaves(
        [t(inp[f"{name}_leaf{i}"]) for i in range(len(names))], mesh, names)
    dp = shd.dp_axes(mesh)
    n, peer = shd.axis_size(mesh, dp), shd.peer_index(mesh, dp)
    batch = {}
    for k in inp.files:
        if k.startswith(name + "_batch_"):
            rows = inp[k].shape[0] // n
            v = t(inp[k][peer * rows:(peer + 1) * rows])
            batch[k[len(name) + 7:]] = v if v.is_floating_point() \\
                else v.long()
    cel = ts.CelerisConfig(mode=mode, min_coded_size=meta["min_coded"],
                           quantize_wire=q)
    step = ts.make_train_step(cfg, mesh, opt, cel)
    row = meta["mask_peer"][name][rank]
    coded = [int(key[len(name) + 5:]) for key in inp.files
             if key.startswith(name + "_mask")]
    masks = {i: t(inp[f"{name}_mask{i}"][row]) for i in coded}
    signs = {i: t(inp[f"{name}_signs{i}"]) for i in coded}
    new, m = step(ts.state_from_params(leaves, cfg, mesh), batch, None,
                  drop, masks=masks, signs=signs)
    mu = chip_smoke.over_data(new, step.data_group)["opt"]["mu"]
    for i, (p, u) in enumerate(zip(new["params"], mu)):
        out[f"{name}_p{i}"], out[f"{name}_mu{i}"] = p.numpy(), u.numpy()
    for key, v in m.items():
        out[f"{name}_m_{key}"] = v.numpy()
    save_zero(name, new, cfg, mesh)
"""

TORCH_END = """
np.savez(d + "/rank%d.npz" % rank, **out)
dist.destroy_process_group()
"""


def _split_dims(mk, jparams):
    specs = jax.tree_util.tree_leaves(
        jrules.param_specs(jparams, _stub_mesh(mk)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [next((j for j, s in enumerate(spec) if s == "model"), None)
            for spec in specs]


def mesh_runs(d, cases, extras=(), torch_tail="", torch_only=()):
    """Run ``cases`` (name -> (arch, mesh, mode, quantize_wire, drop[,
    config overrides])) on four gloo ranks and on JAX's four host
    devices, from JAX's weights (PRNGKey 0, float32 smoke; each rank its
    ``convert.shard_leaves``), the JAX pipeline's global batch of
    ``BATCH`` rows (with a stub's extras for the names in ``extras``,
    :func:`make_batch`) split by rows over the dp ranks, and JAX's draws
    (per leaf at JAX's split dim on the mesh).  ``torch_tail``: code each
    rank runs after the cases, before it saves ``out``; the cases named
    in ``torch_only`` run on the ranks alone.  Returns (inputs, JAX's
    outputs, each rank's)."""
    inp, mask_peer = {}, {}
    key = jax.random.PRNGKey(STEP_KEY)
    for name, (arch, mk, mode, _, drop, *kw) in cases.items():
        jcfg = _cfgs(arch, **(kw[0] if kw else {}))[0]
        jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
        flat = jax.tree_util.tree_leaves(jparams)
        for i, leaf in enumerate(flat):
            inp[f"{name}_leaf{i}"] = np.asarray(leaf)
        for k, v in make_batch(jcfg, SEQ, BATCH,
                               extras=name in extras).items():
            inp[f"{name}_batch_{k}"] = v
        rows, rates = _mask_rows(mk, mode, drop)
        mask_peer[name] = rows
        if mode == "exact":
            continue
        for i, (leaf, sd) in enumerate(zip(flat, _split_dims(mk, jparams))):
            if leaf.size < MIN_CODED:
                continue
            plan = jcoding.plan_nd(leaf.shape, sd, 4096)
            for kind, v in _draws(key, i, plan, range(len(rates)), rates,
                                  False).items():
                inp[f"{name}_{kind}{i}"] = v
    meta = {"meshes": MESHES, "cases": cases, "step_key": STEP_KEY,
            "min_coded": MIN_CODED, "opt": OPT, "mask_peer": mask_peer,
            "torch_only": list(torch_only)}
    return (inp,) + run_sides(
        d, inp, meta, JAX_SIDE, _torch_side(TORCH_SIDE + textwrap.dedent(
            torch_tail) + TORCH_END))


def run_sides(d, inp, meta, jax_side, torch_side):
    """Save ``inp`` (``inputs.npz``) and ``meta`` (``meta.json``) in
    ``d``, then start ``jax_side`` (argv: ``d``; with ``stage`` and
    ``compiled`` defined) in one process with four forced host devices
    and ``torch_side`` (argv: rank, port, ``d``) in four, each under its
    own timeout (``test_torch_dp_train.run_sides``, which logs each
    process's wall and stages).  Returns (``jax.npz``, each rank's
    ``rank<r>.npz``) as dicts."""
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]), OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    dp_train.run_sides(d, dp_train.jax_side(jax_side),
                       textwrap.dedent(torch_side), env, TIMEOUT)
    load = functools.partial(np.load, allow_pickle=False)
    return (dict(load(os.path.join(d, "jax.npz"))),
            [dict(load(os.path.join(d, f"rank{r}.npz")))
             for r in range(WORLD)])


def check_mesh_step(runs, case, cases):
    """Each rank's step against JAX's (the (4, 1) mesh splits no leaf
    over ``model``), ``tests/test_torch_train.py``'s tolerances, and the
    ranks bit-identical; then each rank's ZeRO-1 slices against its
    blocks, by JAX's ``zero1_specs``, of the whole state."""
    inp, jax_out, ranks = runs
    arch, mk, mode, _, _ = cases[case]
    n_leaves = sum(k.startswith(case + "_leaf") for k in inp)
    want = _case(jax_out, case)
    for out in ranks:
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(out[f"{case}_m_{key}"]),
                                       float(want[f"{case}_m_{key}"]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        assert float(out[f"{case}_m_recv_frac"]) == pytest.approx(
            float(want[f"{case}_m_recv_frac"]), abs=1e-7)
        _check_step(out, want, case, n_leaves)
        for key, v in _case(ranks[0], case).items():
            np.testing.assert_array_equal(out[key], v, err_msg=key)
    frac = float(ranks[0][f"{case}_m_recv_frac"])
    assert frac == 1.0 if mode == "exact" else frac < 1.0
    jparams = jax.eval_shape(lambda k: JM.init_params(k, _cfgs(arch)[0]),
                             jax.random.PRNGKey(0))
    specs = [tuple(p) for p in jax.tree_util.tree_leaves(
        jrules.zero1_specs(jparams, _stub_mesh(mk)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert zero1_blocks(ranks, case, *MESHES[mk], specs) == len(specs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(str(tmp_path_factory.mktemp("train_rs_mesh")), CASES,
                     EXTRAS)


@pytest.mark.parametrize("case", list(CASES))
def test_zero1_step_on_the_dp_mesh_matches_jax(runs, case):
    inp = runs[0]
    assert any(k.startswith(case + "_batch_") and "embeds" in k
               for k in inp) == (case in EXTRAS)
    check_mesh_step(runs, case, CASES)
