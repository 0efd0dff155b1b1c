"""Correlation volumes and lookups for the DROID tracker (counterpart of
splatslam_tpu/ops/corr.py; reference correlation_kernels.cu:20-182,
altcorr_kernel.cu:28-352 and droid_net/corr.py).

  * `build_corr_pyramid` — all-pairs correlation (fmap1ᵀ fmap2 / 16) as one
    batched matmul, then 2×2 average pooling per level.
  * `lookup_pyramid`     — bilinear window sampling; the output channel
    order is the CUDA corr_index_forward kernel's (channel c = ix·(2r+1) +
    iy samples at (x+ix−r, y+iy−r), zero outside the map), so pretrained
    DROID weights transfer unchanged.
  * `alt_corr`           — local correlation for the graph update: the
    full-resolution volume exists only for the edges of one call, so the
    caller bounds memory by chunking its edges (factor_graph.corr_chunk).

Feature maps are channel-first (N, C, H, W) and may be bf16; products are
accumulated and the volumes kept in float32 (a bf16 product is exact in
float32). Pixel coordinates are channel-last (N, H, W, 2) as (x, y), like
ops/projective; the features returned are channel-first (N, L·(2r+1)², H,
W), the update operator's input.

The window sampling keeps the JAX package's form: sampling at c+δ is a
contraction with the hat kernel max(0, 1−|Y−c−δ|), separable in x and y —
two small batched matmuls per pixel and no gather. The hat weight equals
corner-masked bilinear interpolation, borders included.
"""

from __future__ import annotations

import torch


def build_corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor):
    """All-pairs correlation (reference corr.py:81-90): fmap1/fmap2
    (N,C,H,W) → (N,H,W,H,W) float32, scaled by 1/16 (each map over 4)."""
    N, C, H, W = fmap1.shape
    f1 = (fmap1 / 4.0).reshape(N, C, H * W).float()
    f2 = (fmap2 / 4.0).reshape(N, C, H * W).float()
    return torch.bmm(f1.transpose(1, 2), f2).reshape(N, H, W, H, W)


def _avg_pool2(x: torch.Tensor):
    """2×2/stride-2 average pooling over the last two axes, floor semantics
    on odd sizes (like F.avg_pool2d)."""
    *lead, H, W = x.shape
    H2, W2 = H // 2, W // 2
    x = x[..., :H2 * 2, :W2 * 2].reshape(*lead, H2, 2, W2, 2)
    return x.mean(dim=(-3, -1))


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """Correlation pyramid: level l has target resolution (H/2ˡ, W/2ˡ)."""
    corr = build_corr_volume(fmap1, fmap2)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = _avg_pool2(corr)
        pyramid.append(corr)
    return pyramid


def _bilinear_window_sample(volume, coords, radius: int):
    """(2r+1)² window around coords from per-pixel 2D slices. volume
    (N,H1,W1,H2,W2); coords (N,H1,W1,2) as (x, y) in the level's target
    frame → (N,H1,W1,(2r+1)²), x-offset major, zero outside the map."""
    N, H1, W1, H2, W2 = volume.shape
    rd = 2 * radius + 1
    dev = volume.device
    off = torch.arange(-radius, radius + 1, device=dev, dtype=volume.dtype)

    def hat(c, size):
        # (N,H1,W1,rd,size): weight of integer position p for offset δ.
        # The two kinks take JAX's subgradients, so that a coordinate that
        # lands on an integer gets the gradient the JAX package gives it:
        # |d| at d = 0 has slope +1 (jnp.abs; torch's abs gives 0), and
        # max(0, ·) at a tie splits the gradient between its two sides
        # (jnp.maximum and torch.maximum; clamp would pass all of it)
        p = torch.arange(size, device=dev, dtype=volume.dtype)
        d = p - c[..., None, None] - off[:, None]
        w = 1.0 - torch.where(d >= 0, d, -d)
        return torch.maximum(w, torch.zeros((), dtype=w.dtype, device=dev))

    wy = hat(coords[..., 1].to(volume.dtype), H2)
    wx = hat(coords[..., 0].to(volume.dtype), W2)
    tmp = torch.matmul(wy, volume)                      # (N,H1,W1,rd_y,W2)
    out = torch.matmul(wx, tmp.transpose(-1, -2))       # (N,H1,W1,rd_x,rd_y)
    return out.reshape(N, H1, W1, rd * rd)


def lookup_pyramid(pyramid, coords, radius: int = 3):
    """Index the correlation pyramid (reference corr.py:57-67). coords
    (N,H,W,2) in level-0 pixels → (N, L·(2r+1)², H, W), levels in order."""
    out = [_bilinear_window_sample(vol, coords / (2 ** lvl), radius)
           for lvl, vol in enumerate(pyramid)]
    return torch.cat(out, -1).permute(0, 3, 1, 2)


def build_fmap_pyramid(fmaps, num_levels: int = 4):
    """Feature pyramid for alt_corr (reference corr.py:111-124): each level
    is the 2×2 average-pooled map (floor on odd sizes), all over 4.
    fmaps (P,C,H,W) → list of (P,C,H/2ˡ,W/2ˡ)."""
    x = fmaps / 4.0
    pyr = [x]
    for _ in range(num_levels - 1):
        x = _avg_pool2(x)
        pyr.append(x)
    return pyr


def alt_corr(fmap_pyr, ii, jj, coords, radius: int = 3):
    """Local correlation of edges ii → jj (reference corr.py:126-145).
    fmap_pyr: the levels of build_fmap_pyramid; ii/jj (N,) rows of it;
    coords (N,H,W,2) level-0 targets → (N, L·(2r+1)², H, W), the layout of
    lookup_pyramid.

    Bilinear window sampling is linear in f2, so <f1, bilerp(f2)> equals
    bilerp(<f1, f2(·)>): correlate first (one matmul per level), then
    window-sample the scalar volume. The level-0 volume is N·(H·W)²·4
    bytes: the caller chunks its edges."""
    N, H, W, _ = coords.shape
    f1 = fmap_pyr[0][ii]
    C = f1.shape[1]
    f1 = f1.reshape(N, C, H * W).float().transpose(1, 2)
    out = []
    for lvl, fm in enumerate(fmap_pyr):
        H2, W2 = fm.shape[-2:]
        vol = torch.bmm(f1, fm[jj].reshape(N, C, H2 * W2).float())
        out.append(_bilinear_window_sample(
            vol.reshape(N, H, W, H2, W2), coords / (2 ** lvl), radius))
    return torch.cat(out, -1).permute(0, 3, 1, 2)
