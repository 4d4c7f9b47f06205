"""The port's int8 quantize, fused rotate+quantize and int8 wire against
the JAX package's, on identical numpy inputs and noise.

On the CPU ``repro_torch.kernels.ops`` runs the plain versions; the CUDA
kernels are held to those same plain versions on the card by
``chip_smoke.py`` (codes and scales equal, and the fused kernel equal to
the kernel pair).  Tolerances:

- ``quantize_int8``: codes equal; scales rtol 1e-6 (``tests/
  test_kernels.py``'s bar for the Pallas kernel against its oracle);
- ``fwht_quantize`` against the JAX oracle (the same butterfly in the
  same order): codes equal, scales rtol 1e-6; against the Pallas kernel
  (interpret mode, a two-matmul rotation that differs at float32 ulp):
  codes within one, dequantized within one quantization step, as
  ``test_kernels.py:109-124`` holds the Pallas kernel to its oracle;
- the int8 wire round trip: atol 1e-5 against JAX's oracle path (float32
  FWHTs in the same order, decode sums in another).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import coding as tcoding
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant


def _inputs(rows, n, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * scale).astype(np.float32)
    noise = rng.random((rows, n), dtype=np.float32)
    signs = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return x, noise, signs


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("rows,n", [(8, 128), (64, 512), (3, 64)])
def test_quantize_int8_matches_jax(rows, n, use_pallas):
    x, noise, _ = _inputs(rows, n, rows * n)
    x[0] = 0.0                                   # an all-zero row: scale 1
    q, s = tops.quantize_int8(torch.as_tensor(x), torch.as_tensor(noise))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (rows,) and float(s[0]) == 1.0
    jq, js = (jops.quantize_int8(jnp.asarray(x), jnp.asarray(noise))
              if use_pallas else
              jref.quantize_int8(jnp.asarray(x), jnp.asarray(noise)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


def test_quantize_codes_clip_and_round_stochastically():
    x = torch.tensor([[-1.0, 1.0, 0.5, 0.0]])
    noise = torch.tensor([[0.0, 0.999, 0.0, 0.7]])
    q, s = tops.quantize_int8(x, noise)
    assert float(s[0]) == pytest.approx(1 / 127)
    # 127 * 1.0 + 0.999 floors to 127, never past the clip
    assert q.tolist() == [[-127, 127, 63, 0]]
    np.testing.assert_allclose(
        tops.dequantize_int8(q, s).numpy(),
        np.asarray(jops.dequantize_int8(jnp.asarray(q.numpy()),
                                        jnp.asarray(s.numpy()))))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("rows,n", [(8, 128), (3, 256), (100, 1024)])
def test_fwht_quantize_matches_jax_oracle(rows, n, signed):
    x, noise, signs = _inputs(rows, n, rows + n)
    kw_t = dict(scale=n ** -0.5)
    kw_j = dict(scale=n ** -0.5, use_pallas=False)
    if signed:
        kw_t["signs"] = torch.as_tensor(signs)
        kw_j["signs"] = jnp.asarray(signs)
    q, s = tops.fwht_quantize(torch.as_tensor(x), torch.as_tensor(noise),
                              **kw_t)
    jq, js = jops.fwht_quantize(jnp.asarray(x), jnp.asarray(noise), **kw_j)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    # the fused function is the pair, fwht then quantize
    y = tops.fwht(torch.as_tensor(x), signs=kw_t.get("signs"),
                  scale=n ** -0.5)
    q2, s2 = tops.quantize_int8(y, torch.as_tensor(noise))
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("rows,n", [(16, 512), (8, 128)])
def test_fwht_quantize_matches_jax_pallas_within_one_step(rows, n):
    x, noise, signs = _inputs(rows, n, 9 + n, scale=1.0)
    q, s = tops.fwht_quantize(torch.as_tensor(x), torch.as_tensor(noise),
                              signs=torch.as_tensor(signs), scale=n ** -0.5)
    jq, js = jops.fwht_quantize(jnp.asarray(x), jnp.asarray(noise),
                                signs=jnp.asarray(signs), scale=n ** -0.5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    codes = q.numpy().astype(int) - np.asarray(jq).astype(int)
    assert np.abs(codes).max() <= 1
    d1 = tops.dequantize_int8(q, s).numpy()
    d2 = np.asarray(jops.dequantize_int8(jq, js))
    assert np.all(np.abs(d1 - d2) <= 1.001 * np.asarray(js)[:, None])


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_int8_wire_roundtrip_matches_jax(drop):
    """encode_quantized -> dequantize_wire -> mask -> decode."""
    n = 5000
    rng = np.random.default_rng(11)
    code = jcoding.plan(n)
    x = rng.standard_normal(n).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], code.n_rot).astype(np.float32)
    noise = rng.random((code.n_blocks, code.n_rot), dtype=np.float32)
    mask = (rng.random(code.n_rot) >= drop).astype(np.float32)

    tcode = tcoding.plan(n)
    q, s = tcoding.encode_quantized(torch.as_tensor(x),
                                    torch.as_tensor(signs), tcode,
                                    noise=torch.as_tensor(noise))
    assert q.dtype == torch.int8 and q.shape == tcode.wire_shape
    assert q.is_contiguous() and s.shape == (tcode.n_blocks,)
    wire = tcoding.dequantize_wire(q, s) * torch.as_tensor(mask)[:, None]
    got = tcoding.decode(wire, torch.as_tensor(mask),
                         torch.as_tensor(signs), tcode)

    # JAX draws its noise from a key inside encode_quantized; its oracle
    # pair takes ours instead, and the rest is its own code
    jq, js = jops.fwht_quantize(
        jnp.asarray(np.pad(x, (0, code.padded_len - n)).reshape(
            code.n_blocks, code.n_rot)), jnp.asarray(noise),
        signs=jnp.asarray(signs), scale=code.n_rot ** -0.5, use_pallas=False)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    jwire = jcoding.dequantize_wire(jq.T, js) * jnp.asarray(mask)[:, None]
    want = jcoding.decode(jwire, jnp.asarray(mask), jnp.asarray(signs), code,
                          use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if drop == 0.0:      # quantization noise only
        err = np.linalg.norm(got.numpy() - x) / np.linalg.norm(x)
        assert err < 0.05, err


def test_encode_quantized_needs_a_noise_source():
    code = tcoding.plan(300)
    with pytest.raises(ValueError, match="generator or noise"):
        tcoding.encode_quantized(torch.ones(300), torch.ones(code.n_rot),
                                 code)
    q, s = tcoding.encode_quantized(torch.ones(300), torch.ones(code.n_rot),
                                    code, torch.Generator().manual_seed(0))
    assert q.shape == code.wire_shape and torch.isfinite(s).all()


def test_cpu_inputs_launch_no_quantize_kernel():
    tfwht.launches = tfwht.quantize_launches = tquant.launches = 0
    x, noise = torch.randn(16, 64), torch.rand(16, 64)
    tops.quantize_int8(x, noise)
    tops.fwht_quantize(x, noise, signs=torch.ones(64), scale=0.125)
    code = tcoding.plan(5000)
    tcoding.encode_quantized(torch.randn(5000), torch.ones(code.n_rot), code,
                             torch.Generator().manual_seed(1))
    assert tfwht.launches == tfwht.quantize_launches == tquant.launches == 0


def test_quantize_wrappers_refuse_what_the_kernels_cannot_take():
    """Non-CUDA tensors never fall back to the plain versions."""
    x, noise = torch.randn(4, 64), torch.rand(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.quantize_int8_cuda(x, noise)
    with pytest.raises(ValueError, match="CUDA"):
        tfwht.fwht_quantize_cuda(x, noise)
    # the custom ops hold only the CUDA launchers: a CPU tensor handed to
    # them directly finds no implementation
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.quantize_int8(x, noise)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.fwht_quantize(x, noise, None, 1.0)
    # meta tensors reach the fake implementations: shapes, no values
    meta = torch.empty(4, 64, device="meta")
    for q, scale in (tops.quantize_int8(meta, meta),
                     tops.fwht_quantize(meta, meta)):
        assert q.device.type == scale.device.type == "meta"
        assert (q.dtype, q.shape, scale.shape) == (torch.int8, (4, 64), (4,))
    assert tfwht.quantize_launches == 0 and tquant.launches == 0
