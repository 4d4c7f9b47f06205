"""The port's dry run (``launch/{specs,costs,dryrun}.py``) against the
JAX package's, on torch's fake process group (one process plays a rank
of the mesh; every tensor on meta).

- ``configs``: ``SHAPES``, ``runnable_shapes`` and
  ``active_param_count`` equal JAX's for all ten architectures;
- ``specs``: every input's global shape, dtype and partition spec equal
  JAX's ``specs.*`` on the 16 x 16 production mesh (JAX in a subprocess
  on 256 forced host devices, ``eval_shape`` only): the train, prefill
  and decode inputs, the parameters and the ZeRO-1 train state of every
  architecture; a rank's local tensor is its block of the global shape.
  Decode caches are held to JAX's dp rule only (their ``model`` entries
  dropped: JAX pins nothing over ``model`` there), and a recurrent
  node's 2-D state, which JAX replicates, is held to its shape and dtype
  (the port's decode takes a rank's rows of it);
- ``costs``: the matmul FLOPs of a smoke train step (``exact``, one
  device, remat) equal the ``dot_general`` FLOPs of JAX's jaxpr of its
  step, the remat recompute included;
- ``dryrun``: the scale check at 512 (rank 0) and 1,024 ranks (the last
  rank) in ``lossy_hadamard`` and at 512 in ``hierarchical`` (its (n_pods
  + 1,) drop vector), the serve check's prefill_32k and decode_32k at
  256, a production train cell's record; a planted step that issues
  ``dist.broadcast`` is not ``ok``.  The checks run qwen2-0.5b at its
  widths, the depth cut to 2 layers (1 for the serve check) to keep the
  meta traces short: the census is each layer's alike.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as JC
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
import repro_torch
import repro_torch.configs as TC
from repro_torch.launch import costs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(TC.ARCHS)          # module names: both packages' ``get``
RECURRENT = ("recurrentgemma_9b", "xlstm_350m")

JAX_SIDE = """
import json, sys
import jax
import repro.configs as C
from repro import sharding as shd
from repro.configs.base import SHAPES
from repro.launch import mesh as mesh_mod
from repro.launch import specs


def norm(spec):
    out = [list(a) if isinstance(a, tuple) and len(a) > 1
           else a[0] if isinstance(a, tuple) else a for a in spec]
    while out and out[-1] is None:
        out.pop()
    return out


mesh = mesh_mod.make_production_mesh()
shd.set_global_mesh(mesh)
out = {}
for arch in json.loads(sys.argv[1]):
    cfg = C.get(arch)
    trees = {"train": specs.train_input_specs(cfg, SHAPES["train_4k"], mesh),
             "prefill": specs.prefill_input_specs(cfg, SHAPES["prefill_32k"],
                                                  mesh),
             "decode": specs.decode_input_specs(cfg, SHAPES["decode_32k"],
                                                mesh),
             "params": specs.abstract_params(cfg, mesh),
             "state": specs.abstract_state(cfg, mesh)}
    out[arch] = {
        k: [[jax.tree_util.keystr(p), list(x.shape), str(x.dtype),
             norm(x.sharding.spec)]
            for p, x in jax.tree_util.tree_flatten_with_path(t)[0]]
        for k, t in trees.items()}
print(json.dumps(out))
"""


def norm(spec):
    out = [list(a) if isinstance(a, tuple) and len(a) > 1
           else a[0] if isinstance(a, tuple) else a for a in spec]
    while out and out[-1] is None:
        out.pop()
    return out


@pytest.fixture(scope="module")
def jax_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=256",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(ARCHS)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture
def world256():
    dryrun.fake_world(256)
    yield tmesh.make_production_mesh(device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_active_params_match_jax(arch):
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    assert TC.runnable_shapes(TC.get(arch)) == JC.runnable_shapes(
        JC.get(arch))
    assert TC.get(arch).active_param_count() == JC.get(
        arch).active_param_count()


def _port_tree(arch, kind, mesh):
    """[(path, Spec)] of one of the port's spec trees, in JAX's flatten
    order with JAX's key paths."""
    cfg = TC.get(arch)
    names = convert.leaf_names(cfg)
    if kind == "train":
        t = specs.train_input_specs(cfg, TC.SHAPES["train_4k"], mesh)
    elif kind == "prefill":
        t = specs.prefill_input_specs(cfg, TC.SHAPES["prefill_32k"], mesh)
    elif kind == "params":
        from repro_torch.train import sharding_rules as rules
        return [(rules.keystr(n), s) for n, s in
                zip(names, specs.abstract_params(cfg, mesh))]
    elif kind == "state":
        return tts.state_leaves(specs.abstract_state(cfg, mesh), names)
    else:
        tp = convert.model_group(cfg, mesh)
        batch, caches, index = specs.decode_input_specs(
            cfg, TC.SHAPES["decode_32k"], mesh, tp)
        out = [(f"[0]['{k}']", v) for k, v in sorted(batch.items())]
        kinds = iter(TM.cache_kinds(cfg))
        for part, nodes in (("groups", caches.groups),
                            ("tail", caches.tail)):
            for j, node in enumerate(nodes):
                kind = next(kinds)
                kind = "attn" if kind in TM.ATTN_KINDS else kind
                out += [(f"[1]['{part}'][{j}]['{kind}'].{f.name}",
                         getattr(node, f.name))
                        for f in dataclasses.fields(node)]
        return out + [("[2]", index)]
    return [(f"['{k}']", v) for k, v in sorted(t.items())]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "params",
                                  "state"])
def test_specs_match_jax_on_the_production_mesh(jax_specs, world256, kind):
    mesh = world256
    for arch in ARCHS:
        want = jax_specs[arch][kind]
        got = _port_tree(arch, kind, mesh)
        assert [p for p, _ in got] == [w[0] for w in want], (arch, kind)
        for (path, s), (_, shape, dtype, spec) in zip(got, want):
            what = f"{arch} {kind} {path}"
            assert list(s.shape) == shape, what
            assert str(s.dtype).replace("torch.", "") == dtype, what
            assert tuple(s.local.shape) == specs.local_shape(s.shape, s.spec,
                                                             mesh), what
            port = norm(s.spec)
            if kind == "decode" and path.startswith("[1]"):
                port = norm([None if a == "model" else a for a in s.spec])
                if arch in RECURRENT and len(shape) <= 2:
                    continue          # JAX replicates a 2-D state node
            assert port == spec, (what, port, spec)


def dot_flops(jaxpr, mult=1.0):
    """``dot_general`` FLOPs of a jaxpr, 2 x out x contracted, scans
    times their length, every inner jaxpr walked (remat, pjit, custom
    derivatives)."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0.0
    for eqn in jaxpr.eqns:
        params = eqn.params
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = params["dimension_numbers"]
            k = np.prod([eqn.invars[0].aval.shape[d] for d in lc])
            total += mult * 2.0 * np.prod(eqn.outvars[0].aval.shape) * k
        elif eqn.primitive.name == "scan":
            total += dot_flops(params["jaxpr"], mult * params["length"])
        elif eqn.primitive.name == "cond":
            total += max(dot_flops(b, mult) for b in params["branches"])
        else:
            for v in params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if hasattr(getattr(sub, "jaxpr", sub), "eqns"):
                        total += dot_flops(sub, mult)
    return total


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-9b"])
def test_step_matmul_flops_equal_jax_dot_flops(arch):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    b, s = 2, 32
    opt = dict(lr=1e-3, warmup_steps=10, total_steps=500)
    jstep = jts.make_train_step(jcfg, None, jadamw.OptConfig(**opt),
                                jts.CelerisConfig(mode="exact"))
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    state = {"params": jp, "opt": jax.eval_shape(jadamw.init_opt_state, jp),
             "step": jax.ShapeDtypeStruct((), jnp.int32)}
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
             for k in ("tokens", "labels")}
    want = dot_flops(jax.make_jaxpr(jstep)(
        state, batch, jax.ShapeDtypeStruct((2,), jnp.uint32),
        jax.ShapeDtypeStruct((), jnp.float32)))
    leaves = convert.jax_leaves(
        TM.init_params(tcfg, repro_torch.generator("meta")), tcfg)
    tstep = tts.make_train_step(tcfg, None, tadamw.OptConfig(**opt))
    tbatch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
    c = costs.trace_costs(tstep, tts.state_from_params(leaves, tcfg),
                             tbatch, repro_torch.generator("meta"), 0.0)
    assert want > 0 and c["matmul_flops"] == want
    assert c["transcendental_flops"] > 0 and c["hbm_bytes"] > 0
    assert not c["collectives"]


@pytest.mark.parametrize("n,rank,mode", [(512, 0, "lossy_hadamard"),
                                         (1024, 1023, "lossy_hadamard"),
                                         (512, 0, "hierarchical")])
def test_scale_check_issues_only_plain_collectives(n, rank, mode):
    try:
        rec = dryrun.scale_check_cell("qwen2-0.5b", n, mode, rank=rank,
                                      layers=2)
    finally:
        dist.destroy_process_group()
    assert rec["ok"], rec
    assert rec["mesh"] == f"{n // 256}x16x16" and rec["dp_degree"] == n // 16
    assert not rec["illegal_collectives"]
    assert rec["collective_ops"]["all_reduce"] > 0
    # the sequence pin's gathers and the ZeRO-1 gather of the parameters
    assert rec["collective_ops"]["all_gather"] > 0


def test_a_planted_broadcast_fails_the_scale_check():
    def planted(step):
        def run(state, *a, **k):
            dist.broadcast(state["params"][0], src=0)
            return step(state, *a, **k)
        return run

    try:
        rec = dryrun.scale_check_cell("qwen2-0.5b", 512, rank=0,
                                      step_fn=planted, layers=1)
    finally:
        dist.destroy_process_group()
    assert not rec["ok"]
    assert rec["illegal_collectives"] == {"broadcast": 1}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serve_check_issues_only_plain_collectives(shape):
    try:
        rec = dryrun.serve_check_cell("qwen2-0.5b", shape, False, layers=1)
    finally:
        dist.destroy_process_group()
    assert rec["ok"], rec
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256


def test_train_cell_record():
    try:
        rec = dryrun.lower_cell("qwen2-0.5b", "train_4k", False, layers=2)
    finally:
        dist.destroy_process_group()
    cfg = dataclasses.replace(TC.get("qwen2-0.5b"), n_layers=2)
    assert rec["model_flops"] == 6.0 * cfg.active_param_count() * 256 * 4096
    assert rec["fits"] and 0 < rec["memory"]["peak_bytes"] < 80e9
    assert rec["collective_bytes_total"] == sum(
        v["bytes"] for v in rec["collectives"].values())
    rl = rec["roofline"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert 0 < rl["useful_flops_ratio"] < 1
    assert rec["costs"]["matmul_flops"] > 0
