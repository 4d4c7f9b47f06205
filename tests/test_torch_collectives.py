"""The port's lossy collectives on ``torch.distributed`` against the JAX
package's under ``shard_map``, at world size 4 on the CPU.

Every case runs in ONE launch of four gloo processes and ONE JAX
subprocess with four forced host devices (as ``tests/test_distribution.py``
runs its mesh), started together, each under its own timeout.  Both sides
get the same per-peer draws: the JAX collectives draw peer r's arrival
mask from ``fold_in(key, r)`` and its rounding noise from
``fold_in(fold_in(key, r), 1)``; the test makes those same draws with
JAX and hands them to the port as tensors.  The JAX side runs its jnp
oracles (``use_pallas=False``, as its own shard_map tests do), which take
the port's float32 operations in the same order, so the int8 codes are
equal; the sums over peers are taken in another order.  Tolerances: the
all-reduce estimates atol 1e-5 and received fractions exact; gathers and
all-to-all exact (no arithmetic but masking and XOR).
"""
import functools
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.core import coding as jcoding
from repro.core import lossy_collectives as jlc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, N, M = 4, 5000, 96
PSUM_CASES = {"f32_d0": (False, 0.0, 1), "f32_d05": (False, 0.05, 2),
              "int8_d0": (True, 0.0, 3), "int8_d05": (True, 0.05, 4)}
AG_DROP, A2A_DROP = 0.3, 0.3
TIMEOUT = 240

JAX_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import sharding as shd
from repro.core import coding, lossy_collectives as lc
d = sys.argv[1]
inp = np.load(d + "/inputs.npz")
mesh = shd.make_mesh((4,), ("data",))
code = coding.plan(inp["xs"].shape[1])
signs = jnp.asarray(inp["signs"])
out = {}

def run(f, in_specs, out_specs, *args):
    sm = shd.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_vma=False)
    return [np.asarray(a) for a in jax.jit(sm)(*args)]

for name, q, drop, seed in zip(inp["psum_names"], inp["psum_q"],
                               inp["psum_drop"], inp["psum_seed"]):
    def f(x, key, p, q=bool(q)):
        est, frac = lc.lossy_psum(x[0], "data", key=key, drop_rate=p,
                                  signs=signs, code=code, use_pallas=False,
                                  quantize_wire=q)
        return est[None], frac[None]
    out[name + "_est"], out[name + "_frac"] = run(
        f, (P("data", None), P(), P()), (P("data", None), P("data")),
        jnp.asarray(inp["xs"]), jax.random.PRNGKey(int(seed)),
        jnp.float32(drop))

def ag(x, key, p):
    g, a = lc.lossy_all_gather(x[0], "data", key=key, drop_rate=p)
    return g[None], a[None]
out["ag_gathered"], out["ag_arrived"] = run(
    ag, (P("data", None), P(), P()), (P("data", None, None), P("data", None)),
    jnp.asarray(inp["ag_x"]), jax.random.PRNGKey(int(inp["ag_seed"])),
    jnp.float32(inp["ag_drop"]))

def a2a(x, key, p):
    r, a = lc.lossy_all_to_all(x, "data", key=key, drop_rate=p)
    return r[None], a[None]
out["a2a_recv"], out["a2a_arrived"] = run(
    a2a, (P("data", None), P(), P()), (P("data", None, None), P("data", None)),
    jnp.asarray(inp["a2a_x"]), jax.random.PRNGKey(int(inp["a2a_seed"])),
    jnp.float32(inp["a2a_drop"]))
np.savez(d + "/jax.npz", **out)
"""

TORCH_SIDE = """
import sys
import numpy as np, torch
import torch.distributed as dist
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        rank=rank, world_size=4)
from repro_torch.core import coding, lossy_collectives as lc
inp = np.load(d + "/inputs.npz")
t = lambda a: torch.as_tensor(np.array(a))
x = t(inp["xs"][rank])
code = coding.plan(x.numel())
signs = t(inp["signs"])
out = {}
for i, name in enumerate(inp["psum_names"]):
    est, frac = lc.lossy_psum(
        x, seed=0, drop_rate=float(inp["psum_drop"][i]), signs=signs,
        code=code, quantize_wire=bool(inp["psum_q"][i]),
        mask=t(inp[name + "_masks"][rank]),
        noise=t(inp[name + "_noise"][rank]))
    out[name + "_est"], out[name + "_frac"] = est.numpy(), frac.numpy()
mean, _ = lc.lossy_pmean(x, seed=0, drop_rate=0.05, signs=signs, code=code,
                         mask=t(inp["f32_d05_masks"][rank]))
out["pmean"] = mean.numpy()
est, frac = lc.lossy_psum(x, seed=7, drop_rate=0.05, signs=signs, code=code,
                          quantize_wire=True)
out["drawn_est"], out["drawn_frac"] = est.numpy(), frac.numpy()
g, a = lc.lossy_all_gather(t(inp["ag_x"][rank]), seed=0, drop_rate=0.3,
                           mask=t(inp["ag_masks"][rank]))
out["ag_gathered"], out["ag_arrived"] = g.numpy(), a.numpy()
g, a = lc.lossy_all_gather(t(inp["ag_x"][rank]), seed=0, drop_rate=0.3,
                           mask=t(inp["ag_masks"][rank]), parity=False,
                           tiled=True)
out["ag_noparity"], out["ag_noparity_arrived"] = g.numpy(), a.numpy()
xa = t(inp["a2a_x"][4 * rank: 4 * rank + 4])
r, a = lc.lossy_all_to_all(xa, seed=0, drop_rate=0.3,
                           mask=t(inp["a2a_masks"][rank]))
out["a2a_recv"], out["a2a_arrived"] = r.numpy(), a.numpy()
r, a = lc.lossy_all_to_all(xa.T.contiguous(), seed=0, drop_rate=0.3,
                           mask=t(inp["a2a_masks"][rank]), split_axis=1,
                           concat_axis=1)
out["a2a_axis1_recv"] = r.numpy()
out["exact_psum"] = lc.exact_psum(x).numpy()
out["exact_pmean"] = lc.exact_pmean(x).numpy()
out["exact_ag"] = lc.exact_all_gather(x[:8], tiled=True).numpy()
out["exact_a2a"] = lc.exact_all_to_all(xa).numpy()
np.savez(d + "/rank%d.npz" % rank, **out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _peer_draws(seed, n_rows, drop, noise_shape=None):
    """JAX's per-peer draws: masks from fold_in(key, r), noise from
    fold_in(fold_in(key, r), 1)."""
    key = jax.random.PRNGKey(seed)
    masks, noise = [], []
    for r in range(WORLD):
        kr = jax.random.fold_in(key, r)
        masks.append(np.asarray(jlc.arrival_mask(kr, n_rows, drop)))
        if noise_shape is not None:
            noise.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(kr, 1), noise_shape)))
    return np.stack(masks), (np.stack(noise) if noise else None)


def _seed_with(n_lost_own: int, drop: float) -> int:
    """A key whose draws drop exactly ``n_lost_own`` peers' own shards."""
    for seed in range(100, 400):
        masks, _ = _peer_draws(seed, WORLD, drop)
        if int((~masks[np.arange(WORLD), np.arange(WORLD)]).sum()) \
                == n_lost_own:
            return seed
    raise AssertionError("no such key")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("collectives"))
    rng = np.random.default_rng(0)
    code = jcoding.plan(N)
    inp = {"xs": rng.standard_normal((WORLD, N)).astype(np.float32),
           "signs": rng.choice([-1.0, 1.0], code.n_rot).astype(np.float32),
           "psum_names": np.array(list(PSUM_CASES)),
           "psum_q": np.array([c[0] for c in PSUM_CASES.values()]),
           "psum_drop": np.array([c[1] for c in PSUM_CASES.values()],
                                 np.float32),
           "psum_seed": np.array([c[2] for c in PSUM_CASES.values()])}
    for name, (_, drop, seed) in PSUM_CASES.items():
        inp[name + "_masks"], inp[name + "_noise"] = _peer_draws(
            seed, code.n_rot, drop, (code.n_blocks, code.n_rot))
    inp["ag_seed"] = _seed_with(1, AG_DROP)
    inp["ag_masks"], _ = _peer_draws(inp["ag_seed"], WORLD, AG_DROP)
    inp["ag_x"] = rng.standard_normal((WORLD, M)).astype(np.float32)
    inp["ag_drop"] = np.float32(AG_DROP)
    inp["a2a_seed"] = 5
    inp["a2a_masks"], _ = _peer_draws(5, WORLD, A2A_DROP)
    inp["a2a_x"] = rng.standard_normal((WORLD * WORLD, M)).astype(np.float32)
    inp["a2a_drop"] = np.float32(A2A_DROP)
    np.savez(os.path.join(d, "inputs.npz"), **inp)

    src = os.path.join(REPO, "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    port = str(_free_port())
    procs += [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(TORCH_SIDE), str(r), port, d],
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


@pytest.mark.parametrize("case", list(PSUM_CASES))
def test_lossy_psum_matches_jax(runs, case):
    inp, jax_out, ranks = runs
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[case + "_est"],
                                   jax_out[case + "_est"][r], atol=1e-5)
        assert float(out[case + "_frac"]) == float(jax_out[case + "_frac"][r])
    frac = float(ranks[0][case + "_frac"])
    drop = PSUM_CASES[case][1]
    if drop == 0.0:
        assert frac == 1.0
        want = inp["xs"].sum(0)
        err = np.linalg.norm(ranks[0][case + "_est"] - want)
        err /= np.linalg.norm(want)
        # f32: two float32 FWHTs; int8: quantization noise, the bar of
        # tests/test_distribution.py's quantized-wire test
        assert err < (1e-5 if case.startswith("f32") else 0.05), err
    else:
        assert abs(frac - (1 - drop)) < 0.04


def test_lossy_pmean_is_psum_over_peers(runs):
    _, _, ranks = runs
    for out in ranks:
        np.testing.assert_allclose(out["pmean"], out["f32_d05_est"] / WORLD,
                                   rtol=1e-6)


def test_seeded_draws_give_one_estimate_on_every_rank(runs):
    inp, _, ranks = runs
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["drawn_est"],
                                      ranks[0]["drawn_est"])
        assert float(out["drawn_frac"]) == float(ranks[0]["drawn_frac"])
    assert abs(float(ranks[0]["drawn_frac"]) - 0.95) < 0.04
    want = inp["xs"].sum(0)
    assert np.linalg.norm(ranks[0]["drawn_est"] - want) < np.linalg.norm(want)


def test_all_gather_parity_repairs_the_one_lost_shard(runs):
    inp, jax_out, ranks = runs
    own = inp["ag_masks"][np.arange(WORLD), np.arange(WORLD)]
    assert (~own).sum() == 1
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["ag_arrived"], own)
        np.testing.assert_array_equal(jax_out["ag_arrived"][r], own)
        # repaired bit for bit, on both sides
        np.testing.assert_array_equal(out["ag_gathered"].view(np.int32),
                                      inp["ag_x"].view(np.int32))
        np.testing.assert_array_equal(out["ag_gathered"],
                                      jax_out["ag_gathered"][r])


def test_all_gather_without_parity_leaves_the_hole(runs):
    inp, _, ranks = runs
    own = inp["ag_masks"][np.arange(WORLD), np.arange(WORLD)]
    want = (inp["ag_x"] * own[:, None]).reshape(-1)
    for out in ranks:
        np.testing.assert_array_equal(out["ag_noparity"], want)
        np.testing.assert_array_equal(out["ag_noparity_arrived"], own)


def test_all_to_all_mask_is_symmetric_and_matches_jax(runs):
    inp, jax_out, ranks = runs
    masks = inp["a2a_masks"]                  # masks[src][dst]
    x = inp["a2a_x"].reshape(WORLD, WORLD, M)  # x[src][block dst]
    for r, out in enumerate(ranks):
        # what rank r heard from j is j's coin for destination r
        np.testing.assert_array_equal(out["a2a_arrived"], masks[:, r])
        np.testing.assert_array_equal(jax_out["a2a_arrived"][r],
                                      masks[:, r])
        want = x[:, r] * masks[:, r][:, None]
        np.testing.assert_array_equal(out["a2a_recv"], want)
        np.testing.assert_array_equal(out["a2a_recv"],
                                      jax_out["a2a_recv"][r])
        np.testing.assert_array_equal(out["a2a_axis1_recv"], want.T)


def test_exact_twins(runs):
    inp, _, ranks = runs
    xs = inp["xs"]
    x = inp["a2a_x"].reshape(WORLD, WORLD, M)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["exact_psum"], xs.sum(0), atol=1e-5)
        np.testing.assert_allclose(out["exact_pmean"], xs.mean(0),
                                   atol=1e-6)
        np.testing.assert_array_equal(out["exact_ag"], xs[:, :8].reshape(-1))
        np.testing.assert_array_equal(out["exact_a2a"], x[:, r])
