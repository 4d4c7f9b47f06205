"""The port's Hadamard code and KV hole masks against the JAX package's.

jax.random and torch draw different bits, so the signs, payloads and
counts are made with numpy and handed to both sides.  On the CPU the
port's transforms take the plain versions of its kernels; the JAX side
runs both its Pallas kernels (interpret mode) and its jnp oracles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.core.transport import coupling as jcoupling
from repro.serve import traffic as jtraffic
from repro_torch.core import coding as tcoding
from repro_torch.core.transport import coupling as tcoupling

ATOL = 1e-5     # float32; the two FWHTs sum in different orders


def _inputs(orig_len, n_rot, seed):
    rng = np.random.default_rng(seed)
    code = jcoding.plan(orig_len, n_rot=n_rot)
    x = rng.standard_normal(orig_len).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], code.n_rot).astype(np.float32)
    return code, x, signs


@pytest.mark.parametrize("orig_len,n_rot", [(1000, 256), (4096, 64),
                                            (37, 4096), (1, 8), (5000, 4096)])
def test_plan_matches_jax(orig_len, n_rot):
    j = jcoding.plan(orig_len, n_rot=n_rot)
    t = tcoding.plan(orig_len, n_rot=n_rot)
    assert (t.n_rot, t.n_blocks, t.orig_len) == (j.n_rot, j.n_blocks,
                                                 j.orig_len)
    assert t.wire_shape == j.wire_shape


@pytest.mark.parametrize("orig_len,n_rot", [(1000, 256), (3 * 64 * 50, 64)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_encode_matches_jax(orig_len, n_rot, use_pallas):
    code, x, signs = _inputs(orig_len, n_rot, orig_len)
    want = jcoding.encode(jnp.asarray(x), jnp.asarray(signs), code,
                          use_pallas=use_pallas)
    got = tcoding.encode(torch.as_tensor(x), torch.as_tensor(signs),
                         tcoding.plan(orig_len, n_rot=n_rot))
    assert tuple(got.shape) == code.wire_shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("total_peers", [1, 3])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_decode_matches_jax(total_peers, use_pallas):
    code, x, signs = _inputs(3000, 256, total_peers)
    rng = np.random.default_rng(7)
    wire = rng.standard_normal(code.wire_shape).astype(np.float32)
    counts = rng.integers(0, total_peers + 1, code.n_rot).astype(np.float32)
    counts[:3] = 0.0
    want = jcoding.decode(jnp.asarray(wire), jnp.asarray(counts),
                          jnp.asarray(signs), code, total_peers=total_peers,
                          use_pallas=use_pallas)
    got = tcoding.decode(torch.as_tensor(wire), torch.as_tensor(counts),
                         torch.as_tensor(signs),
                         tcoding.plan(3000, n_rot=256),
                         total_peers=total_peers)
    assert got.shape == (3000,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_roundtrip_lossless_and_lossy_matches_jax():
    code, x, signs = _inputs(5000, 512, 3)
    tcode = tcoding.plan(5000, n_rot=512)
    mask = np.random.default_rng(4).random(code.n_rot) < 0.8
    tx, ts = torch.as_tensor(x), torch.as_tensor(signs)
    wire = tcoding.encode(tx, ts, tcode)
    full = tcoding.decode(wire, torch.ones(tcode.n_rot), ts, tcode)
    np.testing.assert_allclose(full.numpy(), x, atol=ATOL)
    m = torch.as_tensor(mask, dtype=torch.float32)
    got = tcoding.decode(wire * m[:, None], m, ts, tcode)
    jwire = jcoding.encode(jnp.asarray(x), jnp.asarray(signs), code,
                           use_pallas=False)
    jm = jnp.asarray(mask, jnp.float32)
    want = jcoding.decode(jwire * jm[:, None], jm, jnp.asarray(signs), code,
                          use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_all_rows_lost_decodes_to_zero():
    code = tcoding.plan(640, n_rot=64)
    wire = torch.zeros(code.wire_shape)
    out = tcoding.decode(wire, torch.zeros(64), torch.ones(64), code)
    assert torch.all(out == 0)


def test_rademacher_signs_seeded():
    code = tcoding.plan(4096, n_rot=64)
    a = tcoding.rademacher(torch.Generator().manual_seed(5), code)
    b = tcoding.rademacher(torch.Generator().manual_seed(5), code)
    assert a.dtype == torch.float32 and a.shape == (64,)
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kv_frac", [[0.9], [1.0, 0.5, 0.97], [0.0, 0.75]])
def test_kv_hole_masks_bit_identical(kv_frac, seed):
    assert tcoupling.STREAM_KV_HOLES == jtraffic.STREAM_KV_HOLES
    want = jcoupling.kv_hole_masks(np.array(kv_frac), 64, seed=seed)
    got = tcoupling.kv_hole_masks(np.array(kv_frac), 64, seed=seed)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)

