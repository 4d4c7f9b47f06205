"""Serving on a (data, model) mesh: the port's prefill, decode, caches and
coded KV transfer on four gloo ranks against the JAX package's
``make_prefill``/``make_decode`` on the same mesh (four forced host
devices, ``set_global_mesh``, the parameters placed by
``param_shardings`` and the batch by ``batch_specs``), float32 at smoke
widths, a global batch of 4 rows (2 a dp rank on (2, 2)).

Every case runs in ONE launch of four gloo processes and ONE JAX
subprocess (``test_torch_train_recurrent_stubs_mesh.run_sides``).  Both
sides start from JAX's weights (PRNGKey 0; each rank its
``convert.shard_leaves``) and the same numpy prompt, image embeds or
frames, teacher-forced tokens, wire mask and signs; each rank takes its
dp block of the rows (``serve_step.local_batch``).  The mesh matters:
JAX's EP prefill sizes expert capacity per sender over the global batch
(``moe.py:203``), so a MoE model on a JAX mesh and on one JAX device
differ once capacity binds.  Cases:

- gemma2-9b on (2, 2), kv heads split (2 over 2), and on (1, 4), kv
  heads whole (2 % 4) with padded q heads; an 80-token prompt wraps the
  64-slot rings of its local layers;
- qwen2-moe-a2.7b on (2, 2): capacity binds, EP prefill with the dp
  ranks' rows routed together, decode over the gathered experts;
- recurrentgemma-9b on (1, 4): the RG-LRU state by channel, the MQA
  ring whole;
- xlstm-350m on (2, 2) (one mLSTM head a rank) and (1, 4) (whole heads);
- phi-3-vision-4.2b on (2, 2) with image embeds;
- seamless-m4t-medium on (1, 4) with frames and a 514-row vocabulary,
  which 4 does not divide: the embedding and logits stay whole.

Per case: the prefill logits and each teacher-forced decode step's
logits against JAX's (``TOL``); the port's greedy tokens equal to JAX's
wherever every top-2 gap so far exceeds ``TOL``; every rank's caches
against its slice of JAX's, by the port's layout
(``model.cache_split_dims``); the degraded K/V bit for bit the matching
slice of the one-device ``degrade_caches`` of the gathered clean leaves
where the rank's blocks are blocks of the global leaf (qwen2-moe and
phi-3-vision on (2, 2), and every leaf kept whole on a (1, 4) mesh),
the rank's own coding elsewhere; ``kv_position_error`` on the mesh equal
to the one-device value; ``cache_specs`` equal to JAX's on the same
tree.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as TC
from repro_torch import sharding as tshd
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.serve import serve_step as TS
from repro_torch.train import sharding_rules as trules
from repro_torch.launch import mesh as tmesh
from test_torch_tp_train import MESHES, _coords
from test_torch_train_recurrent_stubs_mesh import REPO, run_sides

B, GEN, N_ROT = 4, 4, 64
# float32 logits: the mesh's partial sums add up in another order than
# GSPMD's (~1e-6 at these widths)
TOL = dict(rtol=1e-4, atol=1e-4)
# name -> (arch, mesh, prompt length, config overrides)
CASES = {
    "gemma2_dm22": ("gemma2-9b", "dm22", 80, {}),
    "gemma2_dm14": ("gemma2-9b", "dm14", 80, {}),
    "qwen2moe_dm22": ("qwen2-moe-a2.7b", "dm22", 32, {}),
    "rg_dm14": ("recurrentgemma-9b", "dm14", 32, {}),
    "xlstm_dm22": ("xlstm-350m", "dm22", 32, {}),
    "xlstm_dm14": ("xlstm-350m", "dm14", 32, {}),
    "phi3_dm22": ("phi-3-vision-4.2b", "dm22", 32, {}),
    "seamless_v514_dm14": ("seamless-m4t-medium", "dm14", 32,
                           {"vocab_size": 514}),
}

JAX_SIDE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
import repro.configs as C
from repro import sharding as shd
from repro.models import model as M
from repro.serve import serve_step as S
from repro.train import sharding_rules as rules
d = sys.argv[1]
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
out, specs = {}, {}


def norm(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return list(entry) if isinstance(entry, tuple) else entry


for name, (arch, mk, plen, kw) in meta["cases"].items():
    mesh = shd.make_mesh(*map(tuple, meta["meshes"][mk]))
    shd.set_global_mesh(mesh)
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32", **kw)
    p = M.init_params(jax.random.PRNGKey(0), cfg)
    p = jax.device_put(p, rules.param_shardings(p, mesh))
    batch = {k[len(name) + 7:]: jnp.asarray(inp[k]) for k in inp.files
             if k.startswith(name + "_batch_")}
    batch = jax.device_put(batch, jax.tree.map(
        lambda s: NamedSharding(mesh, s), rules.batch_specs(mesh, batch)))
    start = plen + (cfg.n_frontend_tokens if cfg.frontend == "vision_stub"
                    else 0)
    logits, caches = S.make_prefill(cfg, start + meta["gen"])(p, batch)
    out[name + "_prefill"] = np.asarray(logits)
    leaves = jax.tree_util.tree_leaves(caches)
    for i, leaf in enumerate(leaves):
        out[f"{name}_cache{i}"] = np.array(leaf)   # decode donates it
    specs[name] = [[norm(e) for e in s] for s in jax.tree_util.tree_leaves(
        rules.cache_specs(mesh, caches),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    extra = {}
    if cfg.is_encdec:
        extra["memory"] = jax.jit(lambda q, b: M._encode(q, cfg, b))(p,
                                                                     batch)
    decode = S.make_decode(cfg)
    forced = jnp.asarray(inp[name + "_forced"])
    c = jax.tree.map(jnp.copy, caches)
    for t in range(meta["gen"]):
        lg, c = decode(p, c, dict(extra, tokens=forced[:, t:t + 1]),
                       jnp.int32(start + t))
        out[f"{name}_forced{t}"] = np.asarray(lg)
    tok = jnp.argmax(logits, -1)[:, None]
    toks = [tok]
    for t in range(meta["gen"] - 1):
        lg, caches = decode(p, caches, dict(extra, tokens=tok),
                            jnp.int32(start + t))
        out[f"{name}_greedy{t}"] = np.asarray(lg)
        tok = jnp.argmax(lg, -1)[:, None]
        toks.append(tok)
    out[name + "_tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
shd.set_global_mesh(None)
np.savez(d + "/jax.npz", **out)
json.dump(specs, open(d + "/jax_specs.json", "w"))
"""

TORCH_SIDE = """
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        rank=rank, world_size=4)
torch.set_num_threads(1)
import repro_torch.configs as C
from repro_torch import sharding as shd
from repro_torch.models import convert, moe
from repro_torch.models import model as M
from repro_torch.serve import serve_step as S
inp = np.load(d + "/inputs.npz")
meta = json.load(open(d + "/meta.json"))
t = lambda a: torch.as_tensor(np.array(a))
out = {}


def save(key, caches):
    for i, x in enumerate(x for c in caches.nodes() for x in c.tensors()):
        out[f"{key}{i}"] = x.numpy().copy()   # decode writes in place


for name, (arch, mk, plen, kw) in meta["cases"].items():
    mesh = shd.make_mesh(*map(tuple, meta["meshes"][mk]), "cpu")
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32", **kw)
    names = convert.leaf_names(cfg)
    params = convert.params_from_leaves(convert.shard_leaves(
        [t(inp[f"{name}_leaf{i}"]) for i in range(len(names))], mesh,
        names), cfg)
    tp, rows = S.mesh_groups(cfg, mesh)
    batch = {k[len(name) + 7:]: t(inp[k]) for k in inp.files
             if k.startswith(name + "_batch_")}
    batch["forced"] = t(inp[name + "_forced"])
    batch = S.local_batch(mesh, batch)
    tokens, forced = batch.pop("tokens").long(), batch.pop("forced").long()
    memory = None
    if "frame_embeds" in batch:
        memory = M.encode(params, cfg, batch.pop("frame_embeds"), tp)
    start = cfg.n_front + plen
    prefill = S.make_prefill(cfg, start + meta["gen"], tp, rows)
    moe.drop_log = []
    logits, caches = prefill(params, tokens, memory=memory, **batch)
    out[name + "_drops"] = np.int64(sum(int(x) for x in moe.drop_log))
    moe.drop_log = None
    if cfg.moe is not None:          # each rank routing its own rows
        alone, _ = S.make_prefill(cfg, start + meta["gen"], tp)(
            params, tokens, **batch)
        out[name + "_alone"] = alone.numpy()
    out[name + "_prefill"] = logits.numpy()
    save(name + "_cache", caches)
    mask, signs = t(inp[name + "_mask"]), t(inp[name + "_signs"])
    degraded = S.degrade_caches(caches, mask, signs=signs)
    save(name + "_degraded", degraded)
    out[name + "_kverr"] = S.kv_position_error(
        caches, degraded, meta["n_ctx"][name], cfg, tp, rows).numpy()
    decode = S.make_decode(cfg, tp, rows)
    c = caches.clone()
    for step in range(meta["gen"]):
        lg, c = decode(params, c, forced[:, step:step + 1], start + step,
                       memory)
        out[f"{name}_forced{step}"] = lg.numpy()
    out[name + "_tokens"] = S.greedy_decode(
        cfg, params, caches, torch.argmax(logits, -1)[:, None], start,
        meta["gen"], memory, tp, rows).numpy()
np.savez(d + "/rank%d.npz" % rank, **out)
dist.destroy_process_group()
"""


def _cfg(case):
    arch, _, _, kw = CASES[case]
    return dataclasses.replace(TC.get_smoke(arch), dtype="float32", **kw)


def _n_ctx(case):
    """The positions ``kv_position_error`` reads: the prefilled ones, at
    most the smallest leaf's slots (a wrapped ring)."""
    cfg = _cfg(case)
    n = cfg.n_front + CASES[case][2]
    return min(n, cfg.window_size) if "local" in cfg.block_pattern else n


def _inputs():
    import jax
    from repro.models import model as JM
    import repro.configs as JC
    rng = np.random.default_rng(0)
    inp = {}
    for name, (arch, _, plen, kw) in CASES.items():
        jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32",
                                   **kw)
        leaves = jax.tree_util.tree_leaves(
            JM.init_params(jax.random.PRNGKey(0), jcfg))
        for i, leaf in enumerate(leaves):
            inp[f"{name}_leaf{i}"] = np.asarray(leaf)
        v = jcfg.vocab_size
        inp[f"{name}_batch_tokens"] = rng.integers(0, v, (B, plen),
                                                   dtype=np.int32)
        if jcfg.frontend == "vision_stub":
            inp[f"{name}_batch_image_embeds"] = rng.standard_normal(
                (B, jcfg.n_frontend_tokens, jcfg.frontend_dim)
            ).astype(np.float32)
        if jcfg.is_encdec:
            inp[f"{name}_batch_frame_embeds"] = rng.standard_normal(
                (B, plen, jcfg.frontend_dim)).astype(np.float32)
        inp[f"{name}_forced"] = rng.integers(0, v, (B, GEN), dtype=np.int32)
        mask = np.ones(N_ROT, np.float32)
        mask[rng.choice(N_ROT, 7, replace=False)] = 0
        inp[f"{name}_mask"] = mask
        inp[f"{name}_signs"] = rng.choice([-1.0, 1.0], N_ROT).astype(
            np.float32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_mesh"))
    meta = {"meshes": MESHES, "cases": CASES, "gen": GEN,
            "n_ctx": {c: _n_ctx(c) for c in CASES}}
    inp = _inputs()
    jax_out, ranks = run_sides(d, inp, meta, JAX_SIDE, TORCH_SIDE)
    with open(os.path.join(d, "jax_specs.json")) as f:
        specs = json.load(f)
    return jax_out, ranks, specs, inp


def _layout(case):
    """(the port's specs of the case's whole caches, with its ``model``
    dims; the same without them; the whole caches' shapes), flat: every
    rank's layout is the same, only its block differs."""
    cfg = _cfg(case)
    whole = TM.init_caches(cfg, B, cfg.n_front + CASES[case][2] + GEN,
                           "meta")
    with _as_rank(case, 0) as (mesh, tp):
        dims = TM.cache_split_dims(cfg, tp)
        mine = trules.cache_specs(mesh, whole,
                                  [dims[k] for k in TM.cache_kinds(cfg)])
    plain = trules.cache_specs(
        types.SimpleNamespace(mesh_dim_names=MESHES[CASES[case][1]][1]),
        whole)
    return _flat(mine), _flat(plain), [tuple(t.shape) for t in _flat(whole)]


@contextlib.contextmanager
def _as_rank(case, r):
    """Rank ``r``'s mesh of the case and its model group, on a ``fake``
    process group of four ranks in this process (no collective runs)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=r,
                            world_size=4)
    try:
        shape, names = MESHES[CASES[case][1]]
        mesh = tmesh.make_host_mesh(shape, names, device_type="cpu")
        yield mesh, convert.model_group(_cfg(case), mesh)
    finally:
        dist.destroy_process_group()


def _flat(caches):
    return [t for n in caches.nodes() for t in n.tensors()]


def _whole(ranks, key, spec, shape, mk):
    """The whole array from the ranks' blocks; ranks holding one block
    must agree bit for bit."""
    sizes = dict(zip(MESHES[mk][1], MESHES[mk][0]))
    x = np.zeros(shape, ranks[0][key].dtype)
    seen = {}
    for r, coords in enumerate(_coords(mk)):
        at = tshd.block_slices(shape, spec, sizes, coords)
        block = ranks[r][key]
        first = seen.setdefault(repr(at), block)
        np.testing.assert_array_equal(block, first, err_msg=key)
        x[at] = block
    return x


def _rows(mk, r):
    """Rank ``r``'s rows of the global batch."""
    coords = _coords(mk)[r]
    sizes = dict(zip(MESHES[mk][1], MESHES[mk][0]))
    n = sizes.get("data", 1)
    i = int(coords["data"]) if "data" in coords else 0
    return slice(i * B // n, (i + 1) * B // n)


def test_the_cases_lay_out_what_they_claim():
    """The port's ``model`` layout of each case's caches: gemma2's kv
    heads split on (2, 2) and whole on (1, 4); the RG-LRU state split by
    channel beside a whole MQA ring; the mLSTM state by head on (2, 2),
    whole on (1, 4); the sLSTM state whole; seamless's vocabulary whole
    on (1, 4)."""
    def model_dims(case):
        specs, _, _ = _layout(case)
        return [s.index("model") - len(s) if "model" in s else None
                for s in specs]

    # AttnCache (k, v, pos) nodes: gemma2's two groups
    assert model_dims("gemma2_dm22") == [-2, -2, None] * 2
    assert model_dims("gemma2_dm14") == [None] * 6
    # recurrentgemma smoke: one (rglru, rglru, local) group, two rglru tails
    assert model_dims("rg_dm14") == [-1, -1] * 2 + [None] * 3 + [-1, -1] * 2
    # xlstm: (mlstm c, n, m) x 3, then slstm (h, c, n, m)
    assert model_dims("xlstm_dm22") == [-3, -2, -1] * 3 + [None] * 4
    assert model_dims("xlstm_dm14") == [None] * 13
    assert model_dims("qwen2moe_dm22") == [-2, -2, None]
    assert model_dims("seamless_v514_dm14") == [-2, -2, None]
    assert _cfg("seamless_v514_dm14").vocab_size % 4


@pytest.mark.parametrize("case", list(CASES))
def test_cache_specs_match_jax(runs, case):
    """``sharding_rules.cache_specs`` without ``model`` dims is JAX's
    ``cache_specs`` on the same tree: the batch dim over the dp axes, the
    ``pos`` arrays replicated."""
    _, plain, _ = _layout(case)
    want = runs[2][case]
    assert len(plain) == len(want)
    for got, w in zip(plain, want):
        got = list(got) + [None] * (len(w) - len(got))
        assert got == w, (got, w)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax_on_the_mesh(runs, case):
    """Each rank's prefill logits (over the whole vocabulary) and each
    teacher-forced decode step's against its rows of JAX's on the same
    mesh; its greedy tokens equal JAX's wherever every top-2 gap so far
    exceeds the tolerance."""
    jax_out, ranks, _, _ = runs
    mk = CASES[case][1]
    for r, out in enumerate(ranks):
        rows = _rows(mk, r)
        want = jax_out[case + "_prefill"][rows]
        assert out[case + "_prefill"].shape == want.shape
        np.testing.assert_allclose(out[case + "_prefill"], want, **TOL)
        for t in range(GEN):
            np.testing.assert_allclose(out[f"{case}_forced{t}"],
                                       jax_out[f"{case}_forced{t}"][rows],
                                       **TOL, err_msg=f"step {t}")
        steps = [jax_out[case + "_prefill"]] + [
            jax_out[f"{case}_greedy{t}"] for t in range(GEN - 1)]
        gaps = np.stack([np.diff(np.sort(s, -1)[:, -2:], axis=-1)[:, 0]
                         for s in steps], 1)[rows]
        clear = np.cumprod(gaps > 2 * TOL["atol"] + TOL["rtol"] * np.abs(
            np.stack([s.max(-1) for s in steps], 1)[rows]), axis=1) > 0
        got, jt = out[case + "_tokens"], jax_out[case + "_tokens"][rows]
        np.testing.assert_array_equal(got[clear], jt[clear])
        assert clear[:, 0].all(), "the first token is a near-tie"


def test_moe_routes_the_dp_rows_together(runs):
    """qwen2-moe's prefill on (2, 2): capacity binds (picks dropped), and
    only routing the dp ranks' rows together matches JAX's mesh; each
    rank routing its own rows sizes capacity over its rows and does
    not."""
    jax_out, ranks, _, _ = runs
    case = "qwen2moe_dm22"
    for r, out in enumerate(ranks):
        assert int(out[case + "_drops"]) > 0
        want = jax_out[case + "_prefill"][_rows("dm22", r)]
        assert np.abs(out[case + "_alone"] - want).max() > 10 * TOL["atol"]


def _kv_tensors(case):
    """Which tensors of the case's flat caches are K/V payloads (an
    attention node's ``k`` and ``v``, its first two fields)."""
    return [isinstance(n, TM.L.AttnCache) and i < 2
            for n in TM.init_caches(_cfg(case), B, 1, "meta").nodes()
            for i in range(len(n.tensors()))]


def _aligned(case):
    """Whether every rank's block of every K/V leaf is made of blocks of
    the global leaf: its flat global indices, in order, whole aligned
    runs of ``N_ROT``."""
    mk = CASES[case][1]
    sizes = dict(zip(MESHES[mk][1], MESHES[mk][0]))
    specs, _, shapes = _layout(case)
    for kv, spec, shape in zip(_kv_tensors(case), specs, shapes):
        if not kv:
            continue
        for coords in _coords(mk):
            idx = np.arange(int(np.prod(shape))).reshape(shape)[
                tshd.block_slices(shape, spec, sizes, coords)].reshape(-1)
            if idx.size % N_ROT:
                return False
            runs = idx.reshape(-1, N_ROT)
            if (runs[:, 0] % N_ROT).any() or (
                    runs != runs[:, :1] + np.arange(N_ROT)).any():
                return False
    return True


def _caches(template, tensors):
    """A ``Caches`` of ``template``'s structure holding ``tensors``
    (flat, node by node)."""
    it = iter(tensors)

    def node(n):
        return type(n)(*(next(it) for _ in n.tensors()))

    return TM.Caches(groups=[node(n) for n in template.groups],
                     tail=[node(n) for n in template.tail])


@pytest.mark.parametrize("case", list(CASES))
def test_caches_and_coded_transfer_on_the_mesh(runs, case):
    """Every rank's caches against its slice of JAX's (the port's
    layout); the ranks' degraded K/V against the one-device
    ``degrade_caches`` of the gathered clean leaves, bit for bit where
    the rank's blocks are blocks of the global leaf, else against the
    one-device coding of its own slices; recurrent state and ``pos``
    unchanged; replicas bit-identical; the mesh's ``kv_position_error``
    equal to the one-device value."""
    jax_out, ranks, _, inp = runs
    mk = CASES[case][1]
    cfg = _cfg(case)
    specs, _, shapes = _layout(case)
    n = len(specs)
    template = TM.init_caches(cfg, B, 1, "meta")
    jax_caches = _caches(template, [torch.as_tensor(jax_out[f"{case}_cache{i}"])
                                    for i in range(n)])
    clean = _caches(template, [torch.as_tensor(
        _whole(ranks, f"{case}_cache{i}", specs[i], shapes[i], mk))
        for i in range(n)])
    deg = _caches(template, [torch.as_tensor(
        _whole(ranks, f"{case}_degraded{i}", specs[i], shapes[i], mk))
        for i in range(n)])
    mask = torch.as_tensor(inp[case + "_mask"])
    signs = torch.as_tensor(inp[case + "_signs"])
    one = TS.degrade_caches(clean, mask, signs=signs)
    aligned = _aligned(case)
    assert aligned == (case not in ("gemma2_dm22", "seamless_v514_dm14"))
    for r, out in enumerate(ranks):
        with _as_rank(case, r) as (mesh, tp):
            want = _flat(TM.local_caches(jax_caches, cfg, mesh, tp))
            want_deg = _flat(TM.local_caches(one, cfg, mesh, tp))
        got = [out[f"{case}_cache{i}"] for i in range(n)]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == tuple(w.shape), (i, g.shape, w.shape)
            if g.dtype.kind == "i":
                np.testing.assert_array_equal(g, w.numpy())
            else:
                np.testing.assert_allclose(g, w.numpy(), **TOL,
                                           err_msg=str(i))
        own = _flat(TS.degrade_caches(
            _caches(template, [torch.as_tensor(g) for g in got]), mask,
            signs=signs))
        for i, kv in enumerate(_kv_tensors(case)):
            g = out[f"{case}_degraded{i}"]
            if not kv:
                np.testing.assert_array_equal(g, got[i])
            else:
                np.testing.assert_array_equal(
                    g, (want_deg if aligned else own)[i].numpy(),
                    err_msg=f"{i} rank {r}")
    want = TS.kv_position_error(clean, deg, _n_ctx(case)).numpy()
    for out in ranks:
        np.testing.assert_allclose(out[case + "_kverr"], want, rtol=1e-5,
                                   atol=1e-7)
    assert (want.max() > 0) == bool(clean.leaves())


def test_serve_launcher_on_a_host_mesh():
    """``launch/serve.py --mesh host`` on four gloo CPU ranks: seamless
    (frames, TP encode, the memory not shipped) with ``--kv-frac``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.serve", "--arch",
         "seamless-m4t-medium", "--smoke", "--device", "cpu", "--mesh",
         "host", "--prompt-len", "32", "--gen", "4", "--kv-frac", "0.9"],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "backend gloo, 4 ranks" in res.stdout
    assert "bytes a rank ships: rank 0 " in res.stdout
    assert "stays with the decoder" in res.stdout
    assert "sample:" in res.stdout


@pytest.mark.parametrize("case", ["gemma2_dm22", "gemma2_dm14"])
def test_local_batch_takes_the_dp_rows(case):
    """``serve_step.local_batch``: each rank its dp block of the rows
    (``batch_specs``), the ranks of a model group the same; rows the dp
    ranks do not divide are refused."""
    tokens = torch.arange(4 * 3).reshape(4, 3)
    for r in range(4):
        with _as_rank(case, r) as (mesh, _):
            got = TS.local_batch(mesh, {"tokens": tokens})["tokens"]
            if MESHES[CASES[case][1]][0][0] > 1:
                with pytest.raises(ValueError, match="do not split"):
                    TS.local_batch(mesh, {"tokens": tokens[:3]})
        np.testing.assert_array_equal(got.numpy(),
                                      tokens[_rows(CASES[case][1], r)].numpy())


@pytest.mark.parametrize("arch", TC.ARCHS)
@pytest.mark.parametrize("mk", ["dm22", "dm14"])
def test_init_caches_on_a_rank_is_its_cut_of_the_whole(arch, mk):
    """Every family at smoke width on (2, 2) and (1, 4): a rank's
    ``init_caches(tp=)`` has the shapes and dtypes of its
    ``local_caches`` cut of the whole caches (each split field its share
    by ``cache_split_dims``), and ``pos`` starts at -1 as on one
    device."""
    cfg = TC.get_smoke(arch)
    shape, names = MESHES[mk]
    rows = B // shape[0]
    whole = TM.init_caches(cfg, B, 24)
    for r in range(4):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=4)
        try:
            mesh = tmesh.make_host_mesh(shape, names, device_type="cpu")
            tp = convert.model_group(cfg, mesh)
            mine = TM.init_caches(cfg, rows, 24, tp=tp)
            cut = TM.local_caches(whole, cfg, mesh, tp)
        finally:
            dist.destroy_process_group()
        for a, b in zip(_flat(mine), _flat(cut)):
            assert a.shape == b.shape and a.dtype == b.dtype, (a.shape,
                                                              b.shape)
            assert torch.equal(a, b)
