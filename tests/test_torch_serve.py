"""The port's serve path against the JAX package's, at smoke size, and
the port's hygiene rules.

Greedy tokens and the degraded KV caches are compared in float32 with
the JAX weights carried across, the same numpy prompt, and the same
signs and wire-row mask (jax.random draws cannot be matched by torch, so
the JAX signs are handed to the port).  degrade_caches: atol 1e-5
(float32 FWHTs summed in different orders); bfloat16: the caches are
coded in float32 and rounded back, so atol 6.25e-2 plus rtol 2^-6, four
bf16 ulps at the caches' size (~3).
"""
import ast
import dataclasses
import functools
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import coding as jcoding
from repro.core.transport import coupling as jcoupling
from repro.models import model as JM
from repro.serve import serve_step as JS
from repro_torch.core.transport import coupling as tcoupling
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import unbias as tunbias
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.serve import serve_step as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, PLEN, GEN, N_ROT = 2, 16, 8, 64
TOL = {"float32": dict(rtol=0.0, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -6, atol=6.25e-2)}


def _np(a):
    return np.asarray(a, np.float32)


@functools.cache
def _served(dtype):
    """Both packages prefilled on the same weights and prompt."""
    jcfg = dataclasses.replace(JC.get_smoke("qwen2-0.5b"), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke("qwen2-0.5b"), dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, PLEN))
    _, jc = JS.make_prefill(jcfg, PLEN + GEN)(jp,
                                              {"tokens": jnp.asarray(prompt)})
    _, tc = TS.make_prefill(tcfg, PLEN + GEN)(tp, torch.as_tensor(prompt))
    return dtype, jcfg, tcfg, jp, tp, prompt, jc["groups"][0]["attn"], tc


@pytest.fixture(params=["float32", "bfloat16"])
def served(request):
    return _served(request.param)


def test_greedy_tokens_identical_f32():
    """float32 only: in bfloat16 a near-tie may pick another token; bf16
    is held to the logits and caches (test_torch_model.py, below)."""
    _, jcfg, tcfg, jp, tp, prompt, _, _ = _served("float32")
    want = JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), GEN)
    got = TS.greedy_generate(tcfg, tp, torch.as_tensor(prompt), GEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("coded", [True, False])
@pytest.mark.parametrize("kv_frac", [0.9, 0.6])
def test_degrade_caches_matches_jax(served, coded, kv_frac):
    dtype, _, _, _, _, _, jcache, tcache = served
    mask = jcoupling.kv_hole_masks(np.array([kv_frac]), N_ROT, seed=1)[0]
    key = jax.random.PRNGKey(42)
    code = jcoding.plan(int(jcache.k.size), n_rot=N_ROT)
    signs = np.array(jcoding.rademacher(key, code))
    jdeg = JS.degrade_caches({"groups": [{"attn": jcache}], "tail": []},
                             jnp.asarray(mask), key,
                             coded=coded)["groups"][0]["attn"]
    tdeg = TS.degrade_caches(tcache, torch.as_tensor(mask), coded=coded,
                             signs=torch.as_tensor(signs))
    clean, deg = tcache.groups[0], tdeg.groups[0]      # qwen2: one group
    assert len(tdeg.groups) == 1 and not tdeg.tail
    for got, want in ((deg.k, jdeg.k), (deg.v, jdeg.v)):
        assert got.dtype == clean.k.dtype and got.shape == clean.k.shape
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   **TOL[dtype])
    assert torch.equal(deg.pos, clean.pos)
    assert deg.pos.data_ptr() != clean.pos.data_ptr()  # no shared state

    want_err = JS.kv_position_error(
        {"groups": [{"attn": jcache}]}, {"groups": [{"attn": jdeg}]}, PLEN)
    got_err = TS.kv_position_error(tcache, tdeg, PLEN)
    assert got_err.shape == (PLEN,)
    np.testing.assert_allclose(got_err.numpy(), _np(want_err),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-4,
                               atol=1e-4)


def test_full_mask_roundtrip_is_identity(served):
    dtype, *_, tcache = served
    full = torch.ones(N_ROT, dtype=torch.bool)
    same = TS.degrade_caches(tcache, full, torch.Generator().manual_seed(2))
    err = TS.kv_position_error(tcache, same, PLEN)
    assert float(err.max()) < (1e-5 if dtype == "float32" else 1e-2)


def test_coded_spreads_loss_that_uncoded_leaves_as_holes():
    """fig8's contrast at smoke size: uncoded loss zeroes whole spans of
    positions, coded loss is small noise at every position."""
    cfg = TC.get_smoke("qwen2-0.5b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, 48),
                           generator=torch.Generator().manual_seed(1))
    _, clean = TS.make_prefill(cfg, 64)(params, prompt)
    mask = torch.as_tensor(
        tcoupling.kv_hole_masks(np.array([0.9]), N_ROT)[0])
    coded = TS.degrade_caches(clean, mask, torch.Generator().manual_seed(2))
    holes = TS.degrade_caches(clean, mask, coded=False)
    e_coded = TS.kv_position_error(clean, coded, 48)
    e_holes = TS.kv_position_error(clean, holes, 48)
    tau = 0.6                                    # fig8's usable threshold
    assert float(e_holes.max()) > tau            # positions lost
    assert float(e_coded.max()) < tau            # every position usable
    assert (e_coded <= tau).float().mean() > (e_holes <= tau).float().mean()


def test_coded_degrade_needs_signs_source(served):
    *_, tcache = served
    with pytest.raises(ValueError, match="generator or signs"):
        TS.degrade_caches(tcache, torch.ones(N_ROT, dtype=torch.bool))


def test_serve_launcher_runs_on_cpu_without_kernel_launches(capsys):
    tfwht.launches = tunbias.launches = 0
    out = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "4",
                        "--kv-frac", "0.9"])
    assert out.shape == (2, 4)
    assert "wire rows lost, coded" in capsys.readouterr().out
    assert tfwht.launches == 0 and tunbias.launches == 0


def test_entry_points_raise_without_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the check is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "qwen2-0.5b", "--smoke"])
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chip_smoke.main()


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """Run without the rest of the repo, the script must fail."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_repro():
    files = list(_port_files())
    assert len(files) > 10
    walked = {os.path.relpath(f, REPO) for f in files}
    for mod in ("specs", "costs", "dryrun"):       # the dry run's modules
        assert f"src/repro_torch/launch/{mod}.py" in walked
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno}: {name}")
    assert not bad, bad
