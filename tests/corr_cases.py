"""Inputs for the local correlation kernel (csrc/corr.cu), made from a
seed with numpy: the tracker's rounds, and the inputs a kernel design can
get wrong. The card tests and chip_smoke.py hold the kernel against the
plain ops/corr.alt_corr on them; the CPU tests hold the dispatch.

The features are bf16 normal draws through build_fmap_pyramid, as the
video stores them. The targets are each source pixel moved by a smooth
flow (a per-edge zoom, rotation and shift, as a reprojection moves it),
plus sub-pixel noise.

    make_case(name) -> dict(pyr (4 levels (P,128,h/2^l,w/2^l) bf16),
        ii, jj (E,) int64 rows of it, coords (E,h,w,2) float32, P, h, w),
        CPU tensors
    alt_corr_f64(pyr, ii, jj, coords) -> the referee: alt_corr's
        arithmetic in float64 on the same levels
"""

from __future__ import annotations

import numpy as np
import torch

from splatslam_tpu_torch.ops import corr as corr_ops

CASES = {
    # name: (E edges, P frames, h, w)
    "frontend": (75, 25, 48, 64),   # a frontend round at 384x512
    "loop": (169, 25, 48, 64),      # a loop-closure round (loop_ba)
    "single": (1, 2, 7, 13),        # one edge, odd sizes: levels 7x13,
                                    # 3x6, 1x3 and an empty 0x1
    "integer": (6, 4, 16, 24),      # targets on integer coordinates
    "outside": (6, 3, 12, 16),      # windows partly and wholly outside
                                    # the map, infinite and NaN targets
    "scattered": (4, 3, 24, 40),    # targets drawn anywhere on the map:
                                    # neighbouring windows far apart
}


def _flow(rng, E, h, w):
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    cx, cy = (w - 1) / 2, (h - 1) / 2
    out = np.empty((E, h, w, 2))
    for e in range(E):
        zoom = 1.0 + 0.05 * rng.randn()
        th = 0.03 * rng.randn()
        sx, sy = rng.uniform(-6, 6, 2)
        x, y = gx - cx, gy - cy
        out[e, ..., 0] = zoom * (np.cos(th) * x - np.sin(th) * y) + cx + sx
        out[e, ..., 1] = zoom * (np.sin(th) * x + np.cos(th) * y) + cy + sy
    return out


def make_case(name, seed=0):
    E, P, h, w = CASES[name]
    rng = np.random.RandomState(seed)
    fmaps = torch.as_tensor(rng.randn(P, 128, h, w).astype(np.float32)
                            ).to(torch.bfloat16)
    pyr = corr_ops.build_fmap_pyramid(fmaps, 4)
    ii = rng.randint(0, P, E)
    jj = (ii + rng.randint(1, P, E)) % P
    coords = _flow(rng, E, h, w) + 0.5 * rng.randn(E, h, w, 2)
    if name == "integer":
        coords = np.round(coords)
    if name == "scattered":
        # every target anywhere within the radius of the map; edge 0 keeps
        # its smooth flow in every other row, so that a warp's pixels
        # split between near and far windows
        size = np.array([w, h], np.float64)
        wild = rng.uniform(-3.0, size + 3.0, (E, h, w, 2))
        wild[0, ::2] = coords[0, ::2]
        coords = wild
    if name == "outside":
        # edge 0 slides off each border in turn; edge 1 lies wholly
        # outside by more than the radius at every level; edge 2 holds
        # infinite targets and edge 3 a NaN one
        coords[0, :, : w // 4, 0] -= w / 2
        coords[0, :, -w // 4:, 0] += w / 2
        coords[0, : h // 3, :, 1] -= h / 2
        coords[1, ..., 0] = rng.choice([-40.0, w + 40.0], (h, w))
        coords[2, 0, :3] = np.inf
        coords[2, 1, :3, 1] = -np.inf
        coords[3, 2, 5, 0] = np.nan
    return dict(pyr=pyr, ii=torch.as_tensor(ii, dtype=torch.long),
                jj=torch.as_tensor(jj, dtype=torch.long),
                coords=torch.as_tensor(coords.astype(np.float32)),
                P=P, h=h, w=w)


def alt_corr_f64(pyr, ii, jj, coords, chunk=8):
    """ops/corr.alt_corr's arithmetic in float64 on the same levels
    (alt_corr itself computes in float32), a few edges at a time."""
    out = []
    for c in range(0, len(ii), chunk):
        i, j, xy = ii[c:c + chunk], jj[c:c + chunk], coords[c:c + chunk]
        N, h, w, _ = xy.shape
        f1 = pyr[0][i].double().reshape(N, 128, h * w).transpose(1, 2)
        lv = []
        for lvl, fm in enumerate(pyr):
            H2, W2 = fm.shape[-2:]
            vol = torch.bmm(f1, fm[j].double().reshape(N, 128, H2 * W2))
            lv.append(corr_ops._bilinear_window_sample(
                vol.reshape(N, h, w, H2, W2), xy.double() / 2 ** lvl, 3))
        out.append(torch.cat(lv, -1).permute(0, 3, 1, 2))
    return torch.cat(out)
