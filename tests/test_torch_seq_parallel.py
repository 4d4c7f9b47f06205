"""Sequence parallelism under remat: on a model group, ``lm_loss``
(``remat=True``, the train step's) keeps the residual stream split over
``model`` between units (``sharding.split_sequence`` /
``gather_sequence``), under JAX's gate (remat, a model group, S > 1,
S % tp == 0).  Only copies are added, so on every rank the loss and
every gradient of its shards equal those of ``remat=False``, bit for
bit.

Four gloo CPU ranks in one launch (``mesh_runs`` of
``tests/test_torch_train_recurrent_stubs_mesh.py``; no case runs on the
JAX side), float32 smoke configs from the port's own weights (seed 0),
a global batch of 8 rows of 32 tokens, each rank its dp rows.  On (2, 2)
and (1, 4): qwen2-0.5b, gemma2-9b (local and global units), granite-moe
(expert parallel, the dp rows routed together, the lossy dispatch at
0.1), recurrentgemma-9b (a unit and a two-layer tail) and seamless with
frames (the encoder's units pinned too, with or without the decoder's
remat, as JAX's ``_encode`` keeps its default).  Each case counts the sequence
gathers; qwen2 on 30 tokens, which 4 does not divide, runs unpinned on
(1, 4) and gathers nothing.
"""
import pytest

from test_torch_train_recurrent_stubs_mesh import WORLD, mesh_runs

ARCHS = ("qwen2-0.5b", "gemma2-9b", "granite-moe-3b-a800m",
         "recurrentgemma-9b", "seamless-m4t-medium")
CASES = {f"{a}_{mk}": (a, mk, 32) for a in ARCHS for mk in ("dm22", "dm14")}
CASES["qwen2-0.5b_dm14_s30"] = ("qwen2-0.5b", "dm14", 30)

TAIL = """
import repro_torch
from repro_torch.models import model as M
from repro_torch.serve import serve_step
CASES = %r
seen = {"n": 0, "bytes": 0}
plain_gather = shd.gather_sequence


def counting(x, tp):
    out = plain_gather(x, tp)
    seen["n"] += 1
    seen["bytes"] += out.numel() * out.element_size()
    return out


shd.gather_sequence = counting
for name, (arch, mk, seq) in CASES.items():
    mesh = shd.make_mesh(*map(tuple, meta["meshes"][mk]), "cpu")
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32")
    names = convert.leaf_names(cfg)
    g = repro_torch.generator("cpu", 0)
    whole = convert.jax_leaves(M.init_params(cfg, g), cfg)
    leaves = convert.shard_leaves(whole, mesh, names)
    tokens = torch.randint(0, cfg.vocab_size, (8, seq), generator=g)
    batch = {"tokens": tokens, "labels": tokens,
             **serve_step.frontend_inputs(cfg, 8, seq, g)}
    batch = serve_step.local_batch(mesh, {
        k: v.float() if v.is_floating_point() else v
        for k, v in batch.items()})
    tp, rows = serve_step.mesh_groups(cfg, mesh)
    lossy = (M.LossyCtx(enabled=True, drop_rate=0.1) if cfg.moe is not None
             else None)
    res = {}
    for remat in (True, False):
        seen.update(n=0, bytes=0)
        p = [x.detach().requires_grad_() for x in leaves]
        loss, _ = M.lm_loss(convert.params_from_leaves(p, cfg), cfg, batch,
                            tp, lossy, rows if cfg.moe is not None else None,
                            remat=remat)
        grads = torch.autograd.grad(loss, p, allow_unused=True,
                                    materialize_grads=True)
        res[remat] = (loss.detach(), grads, dict(seen))
    (l1, g1, s1), (l0, g0, s0) = res[True], res[False]
    out[name + "_equal"] = np.array(bool(torch.equal(l1, l0)) and all(
        torch.equal(a, b) for a, b in zip(g1, g0)))
    out[name + "_finite"] = np.array(bool(torch.isfinite(l1)))
    out[name + "_gathers"] = np.array([s1["n"], s1["bytes"], s0["n"]])
    out[name + "_tp"] = np.array(0 if tp is None else tp.size)
""" % (CASES,)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seq_parallel"))
    return mesh_runs(d, {}, torch_tail=TAIL)[2]


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_equals_no_remat_bit_for_bit(ranks, case):
    arch, mk, seq = CASES[case]
    assert len(ranks) == WORLD
    for out in ranks:
        assert bool(out[case + "_finite"]), case
        assert bool(out[case + "_equal"]), case
        n, nbytes, n_plain = out[case + "_gathers"]
        tp = int(out[case + "_tp"])
        assert tp == (2 if mk == "dm22" else 4)
        if seq % tp:
            assert n == n_plain == nbytes == 0, case  # unpinned: JAX's gate
        elif arch == "seamless-m4t-medium":
            # the encoder remats and pins with or without the decoder's
            # remat, as JAX's ``_encode`` keeps the default
            assert n > n_plain > 0, case
        else:
            assert n_plain == 0, case     # no remat: nothing pinned
            # split before the units, a gather in each unit's forward and
            # its recompute, one after; the encoder's the same
            assert n > 0 and nbytes > 0, case
