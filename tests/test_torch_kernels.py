"""The port's kernel layer (``repro_torch.kernels``) against the JAX
package's, on identical numpy inputs.

On the CPU, ``repro_torch.kernels.ops`` runs the plain PyTorch versions
in ``kernels/ref.py``; those are what these tests hold to the JAX Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and to
the JAX jnp oracles, at ``tests/test_kernels.py``'s tolerances.  The
CUDA kernels themselves cannot run here (no card, no nvcc): they are
held against these same plain versions on the card by ``chip_smoke.py``
at the main path's shapes and at the shapes below.  Here the tests check
that CPU tensors never reach a kernel and that the wrappers refuse
tensors they cannot take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import unbias as tunbias

SHAPES = [(8, 128), (3, 256), (100, 4096), (1, 2), (16, 1024), (257, 512)]
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.as_tensor(a, dtype=torch.float32).to(getattr(torch, dtype))
    return j, t


def _tol(dtype: str, n: int) -> float:
    return 1e-4 if dtype == "float32" else 8e-2 * np.sqrt(n)


@pytest.mark.parametrize("rows,n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fwht_matches_jax(rows, n, dtype):
    x = np.random.default_rng(rows * n).standard_normal((rows, n))
    jx, tx = _pair(x, dtype)
    got = tops.fwht(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    tol = _tol(dtype, n)
    for want in (jops.fwht(jx), jref.fwht(jx)):     # Pallas, jnp oracle
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,n", [(8, 128), (100, 4096), (257, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fwht_fused_signs_scale_matches_jax(rows, n, dtype):
    rng = np.random.default_rng(n + rows)
    x = rng.standard_normal((rows, n))
    signs = rng.choice([-1.0, 1.0], n).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = tops.fwht(tx, signs=torch.as_tensor(signs), scale=n ** -0.5)
    assert got.dtype == tx.dtype
    # the 1/sqrt(n) scale brings the output to unit size: bf16's
    # 8e-2*sqrt(n) for the unnormalized transform becomes 8e-2
    tol = 1e-4 if dtype == "float32" else 8e-2
    for use_pallas in (True, False):
        want = jops.fwht(jx, signs=jnp.asarray(signs), scale=n ** -0.5,
                         use_pallas=use_pallas)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_fwht_matches_hadamard_matmul():
    n = 256
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((5, n)),
                        dtype=torch.float32)
    h = tref.hadamard_matrix(n)
    np.testing.assert_array_equal(h.numpy(),
                                  np.asarray(jref.hadamard_matrix(n)))
    torch.testing.assert_close(tops.fwht(x), x @ h, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("log_n", [1, 5, 9, 12])
def test_fwht_involution(log_n):
    """H(H(x)) = n * x."""
    n = 1 << log_n
    x = torch.as_tensor(np.random.default_rng(log_n).standard_normal((7, n)),
                        dtype=torch.float32)
    torch.testing.assert_close(tops.fwht(tops.fwht(x)) / n, x,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rows,n", [(8, 128), (32, 64), (64, 1000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_unbias_matches_jax(rows, n, dtype):
    rng = np.random.default_rng(rows + n)
    y = rng.standard_normal((rows, n))
    c = rng.integers(0, 5, rows).astype(np.float32)
    c[0] = 0.0                                      # a row with no arrival
    jy, ty = _pair(y, dtype)
    got = tops.masked_unbias(ty, torch.as_tensor(c), 3)
    assert got.dtype == ty.dtype
    got = got.float().numpy()
    assert np.all(got[0] == 0.0)
    for want in (jops.masked_unbias(jy, jnp.asarray(c), total=3),
                 jref.masked_unbias(jy, jnp.asarray(c), 3)):
        # bf16: one rounding of the float32 product (2^-8 relative);
        # the jnp oracle returns the float32 product unrounded
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=1e-6 if dtype == "float32" else 2**-8)


def test_cpu_inputs_launch_no_kernel():
    tfwht.launches = tunbias.launches = 0
    x = torch.randn(16, 64)
    tops.fwht(x, signs=torch.ones(64), scale=0.125)
    tops.masked_unbias(x, torch.ones(16), 1)
    assert tfwht.launches == 0 and tunbias.launches == 0


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """Non-CUDA tensors never fall back to the plain versions."""
    with pytest.raises(ValueError, match="CUDA"):
        tfwht.fwht_cuda(torch.randn(4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tunbias.masked_unbias_cuda(torch.randn(4, 64), torch.ones(4), 1)
    meta = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError):                 # ops routes to the kernel
        tops.fwht(meta)
    with pytest.raises(ValueError):
        tops.masked_unbias(meta, torch.empty(4, device="meta"), 1)
    assert tfwht.launches == 0 and tunbias.launches == 0
