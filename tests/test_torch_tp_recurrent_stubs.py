"""Tensor parallelism for the recurrent families and the modality stubs:
the port's train step on a ``model`` axis against the JAX package's step
on the same mesh, at world size 4 on the CPU, float32 at smoke widths,
seq 32, batch 8.

Every case runs in ONE launch of four gloo processes and ONE JAX
subprocess with four forced host devices, started together, each under
its own timeout (``tests/test_torch_train_recurrent_stubs_mesh.py``'s
``mesh_runs``).  The JAX side registers each mesh (``set_global_mesh``),
so GSPMD splits the leaves by JAX's partition specs; each rank holds its
``convert.shard_leaves`` of JAX's weights (PRNGKey 0), takes its dp
index's rows of the JAX pipeline's global batch (a stub's extras split
with them) and JAX's draws (masks per dp peer, signs at each leaf's
global tile shape).  Cases, on (2, 2) and (1, 4) data x model:

- recurrentgemma-9b on (1, 4), ``lossy_hadamard`` at drop 0.1: the
  RG-LRU split by channel (conv, gates and ``lam`` included), its MLP
  and the MQA local attention whose one kv head stays whole;
- xlstm-350m on (2, 2), ``lossy_hadamard`` at drop 0.1: one mLSTM head
  a rank, the sLSTM's gate gather;
- xlstm-350m on (1, 4), ``exact``: 2 heads over 4 ranks, so the guard
  still splits ``wq`` at half a head and the mLSTM runs whole heads;
- phi-3-vision-4.2b on (1, 4), ``lossy_hadamard`` with image embeds:
  ``frontend_proj`` split by columns and gathered;
- seamless-m4t-medium on (2, 2), ``exact`` with frames: the encoder
  stack, the cross-attention and ``frontend_proj`` split;
- seamless-m4t-medium on (1, 4) with a vocabulary of 514
  (``lossy_hadamard`` with frames), which 4 does not divide: the guard
  keeps the embedding whole while every other leaf splits.

Each rank's loss, nll and grad norm against JAX's (rtol 1e-5),
``recv_frac`` to 1e-7, every parameter and first moment at
``tests/test_torch_train.py``'s tolerances against the matching slice
of JAX's result, the ranks that share a model index bit-identical.
Torch alone: the trainer's checkpoint of xlstm on (2, 2) restores on
(1, 4) and (4, 1), each rank's state leaves its blocks of the saved
state, bit for bit.
"""
import jax
import numpy as np
import pytest

from repro.models import model as JM
from test_torch_dp_train import _case
from test_torch_tp_train import MESHES, _coords
from test_torch_train_families import _cfgs
from test_torch_train_families_mesh import _check_step
from test_torch_train_recurrent_stubs_mesh import _split_dims, mesh_runs

# name -> (arch, mesh, mode, quantize_wire, drop, config overrides)
CASES = {
    "rg_dm14_exact": ("recurrentgemma-9b", "dm14", "exact", False, 0.0, {}),
    "rg_dm14_lh": ("recurrentgemma-9b", "dm14", "lossy_hadamard", False, 0.1,
                   {}),
    "xlstm_dm22_lh": ("xlstm-350m", "dm22", "lossy_hadamard", False, 0.1,
                      {}),
    "xlstm_dm14_exact": ("xlstm-350m", "dm14", "exact", False, 0.0, {}),
    "phi3_dm14_exact": ("phi-3-vision-4.2b", "dm14", "exact", False, 0.0,
                        {}),
    "phi3_dm14_lh": ("phi-3-vision-4.2b", "dm14", "lossy_hadamard", False,
                     0.1, {}),
    "seamless_dm22_exact": ("seamless-m4t-medium", "dm22", "exact", False,
                            0.0, {}),
    "seamless_v514_dm14_exact": ("seamless-m4t-medium", "dm14", "exact",
                                 False, 0.0, {"vocab_size": 514}),
    "seamless_v514_dm14_lh": ("seamless-m4t-medium", "dm14",
                              "lossy_hadamard", False, 0.1,
                              {"vocab_size": 514})}
EXTRAS = ("phi3_dm14_exact", "phi3_dm14_lh", "seamless_dm22_exact",
          "seamless_v514_dm14_exact", "seamless_v514_dm14_lh")
# JAX cannot lower a lossy step on (1, 4) (XLA: "Cross-partition allreduce
# must be in (partial) manual partitioning mode", qwen2-0.5b's too): these
# run on the ranks alone, held to the port's one-device coded step
# (ONE_DEVICE), and their exact twins to JAX's step on the same mesh
TORCH_ONLY = ("rg_dm14_lh", "phi3_dm14_lh", "seamless_v514_dm14_lh")

# rank 0: each TORCH_ONLY case's one-device coded step on the global batch
# from the whole weights: its gradients, coded with the mesh's plans (the
# global shapes' tiles around the model dim) and the same masks and
# signs, then AdamW
ONE_DEVICE = """
for name in meta["torch_only"]:
    if rank:
        break
    arch, mk, mode, q, drop, kw = meta["cases"][name]
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32", **kw)
    names = convert.leaf_names(cfg)
    full = [t(inp[f"{name}_leaf{i}"]) for i in range(len(names))]
    batch = {k[len(name) + 7:]: t(inp[k]) if inp[k].dtype.kind == "f"
             else t(inp[k]).long() for k in inp.files
             if k.startswith(name + "_batch_")}
    mesh = chip_smoke.mesh_shape(*meta["meshes"][mk])   # rank 0 alone
    plans = ts.plan_leaves(convert.leaf_shapes(cfg), mesh,
                           ts.CelerisConfig(mode=mode,
                                            min_coded_size=meta["min_coded"]),
                           names)
    coded = [i for i, p in enumerate(plans) if p is not None]
    loss, nll, _, grads = ts.loss_and_grads(cfg, full, batch)
    grads, frac = ts._code_grads(
        grads, plans, {i: t(inp[f"{name}_mask{i}"][0]) for i in coded},
        {i: t(inp[f"{name}_signs{i}"]) for i in coded})
    new, state, m = adamw.apply_updates(full, grads,
                                        adamw.init_opt_state(full), opt)
    for i, (p, u) in enumerate(zip(new, state["mu"])):
        out[f"one_{name}_p{i}"], out[f"one_{name}_mu{i}"] = (p.numpy(),
                                                             u.numpy())
    m.update(loss=loss, nll=nll, recv_frac=frac)
    for key, v in m.items():
        out[f"one_{name}_m_{key}"] = v.numpy()
"""

# the elastic restart, torch alone: xlstm's trainer checkpoints on (2, 2)
# from the carried weights' shards and restores on (1, 4) and (4, 1)
ELASTIC = """
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Trainer
cfg = dataclasses.replace(C.get_smoke("xlstm-350m"), dtype="float32")
names = convert.leaf_names(cfg)
shapes = convert.leaf_shapes(cfg)
full = [t(inp[f"xlstm_dm22_lh_leaf{i}"]) for i in range(len(names))]
meshes = {k: shd.make_mesh(*map(tuple, meta["meshes"][k]), "cpu")
          for k in ("dm22", "dm14", "dm41")}
data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                      seed=1)
tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt, mesh=meshes["dm22"],
             ckpt_dir=d + "/ckpt", ckpt_every=1, device="cpu")
tr.state = ts.state_from_params(
    convert.shard_leaves(full, meshes["dm22"], names), cfg, meshes["dm22"])
tr.run(1)

def flat_specs(mesh):
    return [s for _, s in ts.state_leaves(ts.state_specs(shapes, mesh, names),
                                          names)]

saved = list(convert.gather_state([x for _, x in ts.state_leaves(tr.state,
                                                                 names)],
                                  flat_specs(meshes["dm22"]), meshes["dm22"]))
for mk in ("dm14", "dm41"):
    back = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt, mesh=meshes[mk],
                   ckpt_dir=d + "/ckpt", device="cpu")
    got = [x for _, x in ts.state_leaves(back.state, names)]
    want = [shd.local_slice(x, s, meshes[mk])
            for x, s in zip(saved, flat_specs(meshes[mk]))]
    out[f"elastic_{mk}"] = np.bool_(back.start_step == 1 and all(
        a.dtype == b.dtype and torch.equal(bits(a), bits(b))
        for a, b in zip(got, want)))
    out[f"elastic_{mk}_split"] = np.int64(sum(
        a.shape != b.shape for a, b in zip(got, saved)))
"""


def _jcfg(case):
    arch, *_, kw = CASES[case]
    return _cfgs(arch, **kw)[0]


def _view(case):
    """JAX's leaf paths of the case's config and each leaf's dim that
    JAX's specs split over ``model`` on the case's mesh, or None."""
    jparams = jax.eval_shape(lambda k: JM.init_params(k, _jcfg(case)),
                             jax.random.PRNGKey(0))
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    return names, _split_dims(CASES[case][1], jparams)


def _shard_of(want, case, model_index):
    """JAX's full step result of ``case`` cut to the shards of the rank
    at ``model_index`` on the ``model`` axis."""
    mk = CASES[case][1]
    tp = dict(zip(MESHES[mk][1], MESHES[mk][0]))["model"]
    out = dict(want)
    for i, dim in enumerate(_view(case)[1]):
        if dim is None:
            continue
        for kind in ("p", "mu"):
            full = want[f"{case}_{kind}{i}"]
            n = full.shape[dim] // tp
            out[f"{case}_{kind}{i}"] = np.take(
                full, range(model_index * n, (model_index + 1) * n), axis=dim)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(str(tmp_path_factory.mktemp("tp_recurrent_stubs")),
                     CASES, EXTRAS, ONE_DEVICE + ELASTIC, TORCH_ONLY)


def test_the_cases_split_what_they_claim():
    """The layouts the cases exist for, by JAX's specs: the recurrent and
    stub leaves split over ``model``, xlstm's (1, 4) ``wq`` at half a
    head, and the 514-row vocabulary kept whole on (1, 4) only."""
    for case in CASES:
        arch = CASES[case][0]
        names, dims = _view(case)
        leaves = {n for n, d in zip(names, dims) if d is not None}
        want = {"recurrentgemma-9b": ("['rglru']['w_in']",
                                      "['rglru']['conv_w']",
                                      "['rglru']['lam']",
                                      "['rglru']['w_out']"),
                "xlstm-350m": ("['mlstm']['wq']", "['mlstm']['w_down']",
                               "['slstm']['w_x']", "['slstm']['w_up1']"),
                "phi-3-vision-4.2b": ("['frontend_proj']",),
                "seamless-m4t-medium": ("['frontend_proj']",
                                        "['xattn']['wq']", "['encoder']")}
        for part in want[arch]:
            assert any(part in n for n in leaves), (case, part)
        # the leaves kept whole: norms, the float32 gates and r_h, w_if
        whole = set(names) - leaves
        assert not any("['w_in']" in n or "['w_x']" in n for n in whole)
        vocab_split = "['embed']['table']" in leaves
        assert vocab_split == ("v514" not in case), case
    hh = _jcfg("xlstm_dm14_exact").n_heads
    assert hh % 4 and not _jcfg("xlstm_dm22_lh").n_heads % 2


def check_tp_step(ranks, want, case):
    """Each rank's step of ``case`` against ``want`` (a whole step's
    result, keyed as the ranks' are) cut to its shards:
    ``tests/test_torch_train.py``'s tolerances, rtol 1e-5 on the loss,
    nll and grad norm, ``recv_frac`` to 1e-7; the ranks that share a
    model index bit-identical."""
    mk, mode = CASES[case][1], CASES[case][2]
    n_leaves = len(_view(case)[1])
    coords = _coords(mk)
    for r, out in enumerate(ranks):
        mine = _shard_of(want, case, int(coords[r]["model"]))
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(out[f"{case}_m_{key}"]),
                                       float(mine[f"{case}_m_{key}"]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        assert float(out[f"{case}_m_recv_frac"]) == pytest.approx(
            float(mine[f"{case}_m_recv_frac"]), abs=1e-7)
        _check_step(out, mine, case, n_leaves)
    for r, out in enumerate(ranks):
        first = next(s for s in range(len(ranks))
                     if coords[s]["model"] == coords[r]["model"])
        for key, v in _case(ranks[first], case).items():
            np.testing.assert_array_equal(out[key], v, err_msg=key)
    frac = float(ranks[0][f"{case}_m_recv_frac"])
    assert frac == 1.0 if mode == "exact" else frac < 1.0


@pytest.mark.parametrize("case", [c for c in CASES if c not in TORCH_ONLY])
def test_tp_step_matches_jax(runs, case):
    inp, jax_out, ranks = runs
    assert any(k.startswith(case + "_batch_") and "embeds" in k
               for k in inp) == (case in EXTRAS)
    check_tp_step(ranks, _case(jax_out, case), case)


@pytest.mark.parametrize("case", TORCH_ONLY)
def test_coded_step_on_1x4_matches_one_device(runs, case):
    """The coded (1, 4) cases that JAX cannot lower: each rank's step
    against the port's one-device coded step with the same draws, on the
    mesh's tiles (its exact twin is held to JAX's step on (1, 4))."""
    inp, jax_out, ranks = runs
    assert case.replace("_lh", "_exact") in CASES
    assert not any(k.startswith(case + "_") for k in jax_out)
    one = {k[4:]: v for k, v in ranks[0].items()
           if k.startswith(f"one_{case}_")}
    assert any(k.startswith(case + "_mask") for k in inp)
    check_tp_step(ranks, one, case)


def test_xlstm_checkpoint_restores_across_meshes(runs):
    """The (2, 2) checkpoint (ZeRO-1 slices of model shards, gathered by
    every rank, written by rank 0) restores through ``Trainer(mesh=)`` on
    (1, 4) and (4, 1), every rank's state leaves its blocks of the saved
    state, bit for bit (each restore keeps blocks: some leaves differ in
shape from the whole ones)."""
    _, _, ranks = runs
    for out in ranks:
        assert bool(out["elastic_dm14"]) and bool(out["elastic_dm41"])
        assert int(out["elastic_dm14_split"]) > 0
        assert int(out["elastic_dm41_split"]) > 0
