"""The port's ND (tiled) coding, XOR parity, block-aligned plans and
tree ravel against the JAX package's, on identical numpy inputs.

The port rotates the tiles through ``ops.fwht`` (the FWHT kernel's plain
version on the CPU) where JAX runs a jnp butterfly along the middle
axis; both apply the signs before the transform and ``n_rot**-0.5``
after it, in float32, so ``encode_nd``/``decode_nd`` agree at atol 1e-6.
XOR parity is a bit operation and is compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro_torch.core import coding as tcoding

ATOL = 1e-6
# (shape, sharded_dim, n_rot): whole leaves, a TP-sharded first dim, a
# TP-sharded last dim, a padded last tile, a leaf smaller than n_rot
CASES = [((24, 64, 32), None, 256), ((8, 96, 16), 0, 128),
         ((6, 40, 8), 2, 64), ((5, 7, 9), None, 64), ((3, 5), 1, 4096)]


def _leaf(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,sd,n_rot", CASES)
def test_plan_nd_matches_jax(shape, sd, n_rot):
    j = jcoding.plan_nd(shape, sd, n_rot)
    t = tcoding.plan_nd(shape, sd, n_rot)
    assert (t.n_rot, t.tiles, t.sharded_dim, t.shape, t.m_orig) == (
        j.n_rot, j.tiles, j.sharded_dim, j.shape, j.m_orig)


@pytest.mark.parametrize("shape,sd,n_rot", CASES)
def test_tiles_roundtrip_matches_jax(shape, sd, n_rot):
    g = _leaf(shape, 1)
    plan = tcoding.plan_nd(shape, sd, n_rot)
    tiles = tcoding.to_tiles_nd(torch.as_tensor(g), plan)
    want = jcoding.to_tiles_nd(jnp.asarray(g), jcoding.plan_nd(shape, sd,
                                                              n_rot))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(want))
    back = tcoding.from_tiles_nd(tiles, plan)
    np.testing.assert_array_equal(back.numpy(), g)


@pytest.mark.parametrize("total_peers", [1, 3])
@pytest.mark.parametrize("shape,sd,n_rot", CASES)
def test_encode_decode_nd_match_jax(shape, sd, n_rot, total_peers):
    rng = np.random.default_rng(len(shape) + n_rot)
    g = _leaf(shape, 2)
    jplan = jcoding.plan_nd(shape, sd, n_rot)
    tplan = tcoding.plan_nd(shape, sd, n_rot)
    signs = rng.choice([-1.0, 1.0], jplan.n_rot).astype(np.float32)
    counts = rng.integers(0, total_peers + 1, jplan.n_rot).astype(np.float32)
    counts[0] = 0.0                                     # a row lost by all

    want_t = jcoding.encode_nd(jnp.asarray(g), jnp.asarray(signs), jplan)
    got_t = tcoding.encode_nd(torch.as_tensor(g), torch.as_tensor(signs),
                              tplan)
    assert got_t.dtype == torch.float32
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL)

    tiles_sum = (np.asarray(want_t) * total_peers
                 * (counts > 0)[None, :, None]).astype(np.float32)
    want = jcoding.decode_nd(jnp.asarray(tiles_sum), jnp.asarray(counts),
                             jnp.asarray(signs), jplan,
                             total_peers=total_peers)
    got = tcoding.decode_nd(torch.as_tensor(tiles_sum),
                            torch.as_tensor(counts), torch.as_tensor(signs),
                            tplan, total_peers=total_peers)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape,sd,n_rot", CASES[:3])
def test_fwht_nd_is_an_involution_and_matches_jax(shape, sd, n_rot):
    plan = tcoding.plan_nd(shape, sd, n_rot)
    t = tcoding.to_tiles_nd(torch.as_tensor(_leaf(shape, 3)), plan)
    once = tcoding.fwht_nd(t, plan)
    want = jcoding.fwht_nd(jnp.asarray(t.numpy()),
                           jcoding.plan_nd(shape, sd, n_rot))
    np.testing.assert_allclose(once.numpy(), np.asarray(want), atol=ATOL)
    torch.testing.assert_close(tcoding.fwht_nd(once, plan), t, rtol=0,
                               atol=1e-5)


def test_full_arrival_decode_is_lossless():
    shape = (4, 96, 40)
    plan = tcoding.plan_nd(shape, None, 512)
    g = torch.as_tensor(_leaf(shape, 4))
    signs = torch.as_tensor(np.random.default_rng(5).choice(
        [-1.0, 1.0], plan.n_rot).astype(np.float32))
    tiles = tcoding.encode_nd(g, signs, plan)
    back = tcoding.decode_nd(tiles, torch.ones(plan.n_rot), signs, plan)
    torch.testing.assert_close(back, g, rtol=0, atol=1e-5)


@pytest.mark.parametrize("orig_len,n_rot,mult", [(5000, 4096, 1),
                                                 (5000, 256, 8),
                                                 (100, 4096, 3)])
def test_plan_block_multiple_matches_jax(orig_len, n_rot, mult):
    j = jcoding.plan(orig_len, n_rot=n_rot, block_multiple=mult)
    t = tcoding.plan(orig_len, n_rot=n_rot, block_multiple=mult)
    assert (t.n_rot, t.n_blocks, t.orig_len) == (j.n_rot, j.n_blocks,
                                                 j.orig_len)
    assert t.n_blocks % mult == 0


def _chunks(g=5, m=33, seed=7):
    return _leaf((g, m), seed)


def test_xor_parity_encode_matches_jax():
    c = _chunks()
    got = tcoding.xor_parity_encode(torch.as_tensor(c))
    want = jcoding.xor_parity_encode(jnp.asarray(c))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("lost", [(), (2,), (0, 3)])
def test_xor_parity_decode_matches_jax(lost):
    c = _chunks()
    parity = tcoding.xor_parity_encode(torch.as_tensor(c))
    arrived = np.ones(len(c), bool)
    arrived[list(lost)] = False
    # lost rows zeroed by a mask multiply: -0.0 where the value was < 0
    damaged = c * arrived[:, None].astype(np.float32)
    if lost:
        assert np.signbit(damaged[~arrived]).any()
    got = tcoding.xor_parity_decode(torch.as_tensor(damaged), parity,
                                    torch.as_tensor(arrived))
    want = jcoding.xor_parity_decode(jnp.asarray(damaged),
                                     jnp.asarray(parity.numpy()),
                                     jnp.asarray(arrived))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    if len(lost) <= 1:          # one loss is rebuilt bit for bit
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      c.view(np.int32))
    else:                       # more stay zero
        assert not got.numpy()[~arrived].any()


def test_xor_parity_scrubs_negative_zero():
    """A lost row of -0.0 must add no sign bits to the recovered row."""
    c = np.array([[1.5, -2.0], [-0.0, -0.0], [3.0, 0.25]], np.float32)
    parity = tcoding.xor_parity_encode(torch.as_tensor(
        np.array([[1.5, -2.0], [4.0, -1.0], [3.0, 0.25]], np.float32)))
    arrived = torch.tensor([True, False, True])
    got = tcoding.xor_parity_decode(torch.as_tensor(c), parity, arrived)
    np.testing.assert_array_equal(got.numpy()[1], [4.0, -1.0])


@pytest.mark.parametrize("bf16_leaf", [False, True])
def test_tree_ravel_roundtrip_matches_jax(bf16_leaf):
    leaves = [_leaf((3, 4), 8), _leaf((5,), 9), _leaf((2, 2, 2), 10)]
    tleaves = [torch.as_tensor(v) for v in leaves]
    jleaves = [jnp.asarray(v) for v in leaves]
    if bf16_leaf:
        tleaves[1] = tleaves[1].bfloat16()
        jleaves[1] = jleaves[1].astype(jnp.bfloat16)
    vec, spec = tcoding.tree_ravel(tleaves)
    jvec, _ = jcoding.tree_ravel(jleaves)
    assert vec.dtype == torch.float32 and vec.numel() == 12 + 5 + 8
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    back = tcoding.tree_unravel(vec, spec)
    for got, want in zip(back, tleaves, strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)
