"""Correlation volume, pyramid and lookup parity: the PyTorch port's
ops/corr.py against the JAX package's on the same numpy inputs (float32,
CPU). The JAX side is channel-last, the port channel-first.

Tolerances are the JAX suite's (tests/test_droid_net.py): rtol 1e-4 /
atol 1e-5 against direct indexing of the volume, atol 2e-4 / rtol 1e-3
between two ways of computing the same lookup.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.ops import corr as jcorr
from splatslam_tpu_torch.ops import corr as tcorr

LOOSE = dict(atol=2e-4, rtol=1e-3)
TIGHT = dict(rtol=1e-4, atol=1e-5)


def _cf(x):
    """channel-last numpy → channel-first tensor."""
    return torch.as_tensor(np.moveaxis(x, -1, 1).copy())


def _cl(x):
    """channel-first tensor → channel-last numpy."""
    return np.moveaxis(x.numpy(), 1, -1)


def _grid(N, H, W):
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    return np.stack([gx, gy], -1)[None].repeat(N, 0).astype(np.float32)


@pytest.mark.parametrize("H,W", [(8, 12), (7, 13)], ids=["even", "odd"])
def test_corr_pyramid_matches_jax(H, W):
    """Every level, floor semantics of the 2×2 pooling on odd sizes."""
    rng = np.random.RandomState(0)
    f1 = rng.randn(2, H, W, 16).astype(np.float32)
    f2 = rng.randn(2, H, W, 16).astype(np.float32)
    want = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got = tcorr.build_corr_pyramid(_cf(f1), _cf(f2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TIGHT)
    np.testing.assert_allclose(
        tcorr.build_corr_volume(_cf(f1), _cf(f2)).numpy(),
        np.asarray(jcorr.build_corr_volume(jnp.asarray(f1),
                                           jnp.asarray(f2))), **TIGHT)


def test_pyramids_floor_odd_sizes():
    """W/8 = 12 → 6 → 3 → 1 (regression of the JAX suite)."""
    f = torch.ones(1, 4, 8, 12)
    pyr = tcorr.build_corr_pyramid(f, f, num_levels=4)
    assert pyr[3].shape == (1, 8, 12, 1, 1)
    fpyr = tcorr.build_fmap_pyramid(f, num_levels=4)
    assert fpyr[3].shape == (1, 4, 1, 1)
    want = jcorr.build_fmap_pyramid(jnp.ones((1, 8, 12, 4)), num_levels=4)
    for g, w in zip(fpyr, want):
        np.testing.assert_allclose(_cl(g), np.asarray(w), atol=1e-7)


@pytest.mark.parametrize("radius", [1, 3])
def test_lookup_matches_jax(radius):
    """Random sub-pixel coords, some of them far outside the map."""
    rng = np.random.RandomState(1)
    N, H, W, C = 2, 7, 13, 16
    f1 = rng.randn(N, H, W, C).astype(np.float32)
    f2 = rng.randn(N, H, W, C).astype(np.float32)
    coords = _grid(N, H, W) + 4.0 * rng.randn(N, H, W, 2).astype(np.float32)
    coords[0, :2] += 100.0
    coords[1, -1] -= 50.0
    want = jcorr.lookup_pyramid(
        jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)),
        jnp.asarray(coords), radius)
    got = tcorr.lookup_pyramid(tcorr.build_corr_pyramid(_cf(f1), _cf(f2)),
                               torch.as_tensor(coords), radius)
    assert got.shape == (N, 4 * (2 * radius + 1) ** 2, H, W)
    np.testing.assert_allclose(_cl(got), np.asarray(want), **LOOSE)


def test_lookup_channel_order_and_bounds():
    """Channel c = ix·(2r+1) + iy samples at (x+ix−r, y+iy−r): integer and
    half-pixel lookups against direct volume indexing; zero outside."""
    rng = np.random.RandomState(3)
    N, H, W, C = 2, 8, 10, 16
    f1 = torch.as_tensor(rng.randn(N, C, H, W).astype(np.float32))
    f2 = torch.as_tensor(rng.randn(N, C, H, W).astype(np.float32))
    pyr = tcorr.build_corr_pyramid(f1, f2, num_levels=2)
    vol = pyr[0].numpy()
    coords = torch.as_tensor(_grid(N, H, W))
    out = tcorr.lookup_pyramid(pyr, coords, radius=1).numpy()
    rd = 3
    y, x = 4, 5
    for i, j in [(0, 0), (1, 1), (2, 0), (0, 2)]:
        np.testing.assert_allclose(out[0, i * rd + j, y, x],
                                   vol[0, y, x, y + j - 1, x + i - 1], **TIGHT)
    out_h = tcorr.lookup_pyramid(pyr, coords + 0.5, radius=1).numpy()
    y, x = 3, 4
    np.testing.assert_allclose(out_h[0, 1 * rd + 1, y, x],
                               vol[0, y, x, y:y + 2, x:x + 2].mean(), **TIGHT)
    out_far = tcorr.lookup_pyramid(pyr, coords + 100.0, radius=1).numpy()
    assert np.abs(out_far).max() == 0.0
    # the border: a window half outside keeps its inside samples
    edge = tcorr.lookup_pyramid(pyr, coords, radius=1).numpy()[0, :, 0, 0]
    assert edge[0 * rd + 0] == 0.0 and edge[1 * rd + 1] != 0.0


def test_alt_corr_matches_volume_lookup_and_jax():
    rng = np.random.RandomState(4)
    P, H, W, C = 3, 8, 9, 16
    fm = rng.randn(P, H, W, C).astype(np.float32)
    ii, jj = np.asarray([0, 1, 2]), np.asarray([1, 2, 0])
    coords = (rng.rand(3, H, W, 2) * np.asarray([W + 2, H + 2]) - 1).astype(
        np.float32)
    fmaps = _cf(fm)
    ti, tj, tc = torch.as_tensor(ii), torch.as_tensor(jj), \
        torch.as_tensor(coords)
    want = tcorr.lookup_pyramid(
        tcorr.build_corr_pyramid(fmaps[ti], fmaps[tj], num_levels=3), tc,
        radius=2)
    got = tcorr.alt_corr(tcorr.build_fmap_pyramid(fmaps, 3), ti, tj, tc,
                         radius=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOOSE)
    jwant = jcorr.alt_corr(jcorr.build_fmap_pyramid(jnp.asarray(fm), 3),
                           jnp.asarray(ii), jnp.asarray(jj),
                           jnp.asarray(coords), radius=2)
    np.testing.assert_allclose(_cl(got), np.asarray(jwant), **LOOSE)
    # chunking the edges changes nothing: every edge is on its own
    parts = torch.cat([tcorr.alt_corr(tcorr.build_fmap_pyramid(fmaps, 3),
                                      ti[c:c + 1], tj[c:c + 1], tc[c:c + 1],
                                      radius=2) for c in range(3)])
    np.testing.assert_allclose(parts.numpy(), got.numpy(), atol=1e-6)


def test_bf16_features_give_float32_volumes():
    """bf16 maps, as the video stores them: products accumulate in float32
    and the result equals the float32 computation on the rounded inputs."""
    rng = np.random.RandomState(5)
    f = torch.as_tensor(rng.randn(2, 32, 6, 8).astype(np.float32))
    fb = f.to(torch.bfloat16)
    vol = tcorr.build_corr_volume(fb[:1], fb[1:])
    assert vol.dtype == torch.float32
    np.testing.assert_allclose(
        vol.numpy(),
        tcorr.build_corr_volume(fb[:1].float(), fb[1:].float()).numpy(),
        atol=1e-6)
    coords = torch.as_tensor(_grid(1, 6, 8)) + 0.3
    out = tcorr.alt_corr(tcorr.build_fmap_pyramid(fb, 2),
                         torch.tensor([0]), torch.tensor([1]), coords)
    assert out.dtype == torch.float32 and out.shape == (1, 2 * 49, 6, 8)
