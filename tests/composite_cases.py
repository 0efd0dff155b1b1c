"""Small hard inputs for the tile compositor (B1/B2), as numpy arrays made
from a seed: the shapes of input that a kernel design can get wrong. The CPU
tests run them through the plain versions against the JAX package, the GPU
tests through the CUDA kernels against the plain versions.

    make_case(name) -> dict(packets (B,N,10) f32, tile_ids (B,T,K) i32,
                            counts (B,T) i32, gout (B,T,5,256) f32, ntx)
"""

from __future__ import annotations

import numpy as np

CASES = (
    "overflow",         # every count exceeds K: the list is cut at K
    "empty_tiles",      # count == 0 in half the tiles and a whole camera
    "padding_inside",   # -1 entries inside min(count, K)
    "k80",              # K = 80: two full staging batches of 32 and a tail
    "k24",              # K = 24: less than one staging batch
    "collisions",       # one id twice in a tile, few ids over all tiles
    "saturated",        # K = 80, opaque Gaussians at entries 28-31 (one
                        # at the 0.99 clamp): T < 1e-4 from entry 31 on
    "elongated",        # long, rotated Gaussians (30 x 3 px) around the
                        # tiles: bounding boxes cover tiles the ellipse misses
    "needle",           # the same, 30 x 0.6 px
)


def make_case(name, seed=11):
    if name not in CASES:
        raise KeyError(name)
    rng = np.random.RandomState(seed + CASES.index(name))
    ntx, nty, B, N = 3, 2, 2, 128
    K = {"k80": 80, "k24": 24, "saturated": 80}.get(name, 16)
    T = ntx * nty
    n_ids = 6 if name == "collisions" else N

    counts = rng.randint(0, K + 4, (B, T))
    if name == "overflow":
        counts = K + rng.randint(1, 9, (B, T))
    elif name == "empty_tiles":
        counts[:, ::2] = 0
        counts[1] = 0
    elif name in ("saturated", "collisions"):
        counts[:] = K
    ids = np.full((B, T, K), -1, np.int64)
    for b in range(B):
        for t in range(T):
            c = min(counts[b, t], K)
            ids[b, t, :c] = rng.randint(0, n_ids, c)
    if name == "padding_inside":
        ids[rng.rand(B, T, K) < 0.3] = -1
    if name == "collisions":
        ids[:, :, 1] = ids[:, :, 0]      # the same Gaussian twice in a row
        ids[:, :, 5] = 3                 # and one Gaussian in every tile

    pk = np.zeros((B, N, 10), np.float32)
    pk[..., 0] = rng.rand(B, N) * ntx * 16.0
    pk[..., 1] = rng.rand(B, N) * nty * 16.0
    pk[..., 2] = 0.05 + 0.1 * rng.rand(B, N)
    pk[..., 3] = 0.01 * rng.randn(B, N)
    pk[..., 4] = 0.05 + 0.1 * rng.rand(B, N)
    pk[..., 5:8] = rng.rand(B, N, 3)
    pk[..., 8] = 0.1 + 0.85 * rng.rand(B, N)
    pk[..., 9] = 1.0 + rng.rand(B, N)
    if name == "saturated":
        pk[..., 2] = pk[..., 4] = 1e-5   # flat over the whole image
        pk[..., 3] = 0.0
        # faint Gaussians (alpha ~0.03) except four opaque ones at entries
        # 28-31 of every list, the first of them at the 0.99 clamp: T runs
        # ~0.4, 4e-3, 4e-4, 4e-5, 4e-6, never near 1e-4, where rounding
        # would decide a weight. Behind them the suffix term
        # (G - s_after)/(1 - alpha) is rounding noise of s_tot - pre; faint
        # entries keep it small.
        pk[..., 8] = 0.03
        pk[:, :4, 8] = 0.9
        pk[:, 0, 8] = 1.0
        ids[ids < 4] = 4
        ids[:, :, 28:32] = np.arange(4)
    if name in ("elongated", "needle"):
        # covariance with axes 30 px and 3 px (needle: 0.6 px), any
        # orientation; means up to 40 px outside the image, so most lists
        # hold Gaussians whose bounding box covers a tile that their
        # ellipse misses
        th = rng.rand(B, N) * np.pi
        minor = 3.0 if name == "elongated" else 0.6
        l1, l2 = 1.0 / 30.0 ** 2, 1.0 / minor ** 2
        c, s = np.cos(th), np.sin(th)
        pk[..., 2] = l1 * c * c + l2 * s * s
        pk[..., 3] = (l1 - l2) * c * s
        pk[..., 4] = l1 * s * s + l2 * c * c
        pk[..., 0] = -40.0 + rng.rand(B, N) * (ntx * 16.0 + 80.0)
        pk[..., 1] = -40.0 + rng.rand(B, N) * (nty * 16.0 + 80.0)
    gout = rng.randn(B, T, 5, 256).astype(np.float32)
    return dict(packets=pk, tile_ids=ids.astype(np.int32),
                counts=counts.astype(np.int32), gout=gout, ntx=ntx)
