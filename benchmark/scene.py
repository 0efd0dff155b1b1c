"""The benchmark's stream generator: the procedural Synthetic scene, drawn
from the run's seed.

A textured height-field room rendered by point splatting with a z-buffer,
as the program's `datasets.Synthetic` renders it: for seed 7 and the same
camera and trajectory parameters the frames are bit-identical to it (the
same numpy RandomState draws, the same projection, sort and hole filling;
a test holds them equal). The hole filling here visits only the pixels
that are still holes, which gives the same frames as filling whole images
and costs a small fraction of it, so that the frames of a run can be
rendered before it starts.

`render_frames` is what a run calls; `Stream` is the object the program
reads frames from (`len`, indexing, `get_intrinsic`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
import os

import numpy as np


def camera(cfg):
    """(H, W, fx, fy, cx, cy) of a configuration's output frames (the
    Synthetic scene renders at the output resolution, without edges); the
    intrinsics resized in float32, as the program's datasets do."""
    c = cfg["cam"]
    H, W = int(c["H_out"]), int(c["W_out"])
    intr = np.asarray([c["fx"], c["fy"], c["cx"], c["cy"]], np.float32)
    intr[[0, 2]] *= W / c["W"]
    intr[[1, 3]] *= H / c["H"]
    return (H, W) + tuple(float(v) for v in intr)


def build_scene(seed, H, W, fx, fy, cx, cy):
    """(points (H·W, 3) float32, colors (H·W, 3) float32) of the scene of
    `seed` (taken modulo 2**32, numpy's seed range)."""
    rng = np.random.RandomState(int(seed) % (1 << 32))
    d = rng.rand(H, W).astype(np.float32)
    for _ in range(40):
        d = 0.25 * (np.roll(d, 1, 0) + np.roll(d, -1, 0)
                    + np.roll(d, 1, 1) + np.roll(d, -1, 1))
    d = 1.5 + 2.0 * (d - d.min()) / (np.ptp(d) + 1e-8)
    tex = rng.rand(H, W, 3).astype(np.float32)
    for _ in range(2):
        tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                      + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    X = (xs - cx) / fx * d
    Y = (ys - cy) / fy * d
    return np.stack([X, Y, d], -1).reshape(-1, 3), tex.reshape(-1, 3)


def trajectory(n_frames, motion_scale, loop_period=0):
    """Camera-to-world poses (n_frames, 4, 4) float64: a smooth orbit whose
    per-frame motion scales with `motion_scale`; with `loop_period` P the
    camera walks back and forth over the first P frames' path."""
    A = 0.06 * motion_scale
    R_amp = 0.015 * motion_scale
    poses = np.zeros((n_frames, 4, 4))
    for k0 in range(n_frames):
        if loop_period > 0:
            P = float(loop_period)
            k = P - abs(k0 % (2.0 * P) - P)
        else:
            k = float(k0)
        c2w = np.eye(4)
        ang = R_amp * np.asarray([np.sin(k / 6.0), np.sin(k / 9.0 + 1.0),
                                  0.5 * np.sin(k / 13.0 + 2.0)])
        cx_, cy_, cz_ = np.cos(ang)
        sx_, sy_, sz_ = np.sin(ang)
        Rx = np.asarray([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]])
        Ry = np.asarray([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        Rz = np.asarray([[cz_, -sz_, 0], [sz_, cz_, 0], [0, 0, 1]])
        c2w[:3, :3] = Rz @ Ry @ Rx
        c2w[:3, 3] = A * np.asarray([np.sin(k / 4.0),
                                     0.6 * np.sin(k / 6.0 + 1.0),
                                     0.8 * np.sin(k / 8.0 + 2.0)])
        poses[k0] = c2w
    return poses


def render(points, colors, c2w, H, W, fx, fy, cx, cy):
    """(image (H,W,3) float32 in [0,1], depth (H,W) float32) seen from
    `c2w`: the nearest point per pixel, then up to 16 passes that fill a
    hole from its right, left, lower and upper neighbour in turn (with
    wrap-around, as np.roll shifts)."""
    w2c = np.linalg.inv(c2w)
    P = (w2c[:3, :3] @ points.T).T + w2c[:3, 3]
    z = P[:, 2]
    ok = z > 0.1
    u = np.round(fx * P[ok, 0] / z[ok] + cx).astype(np.int64)
    v = np.round(fy * P[ok, 1] / z[ok] + cy).astype(np.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v = u[inb], v[inb]
    zi = z[ok][inb]
    ci = colors[ok][inb]
    order = np.argsort(-zi)
    img = np.zeros((H * W, 3), np.float32)
    dep = np.zeros(H * W, np.float32)
    flat = v[order] * W + u[order]
    img[flat] = ci[order]
    dep[flat] = zi[order]
    holes = np.flatnonzero(dep == 0)
    for _ in range(16):
        if holes.size == 0:
            break
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            y, x = holes // W, holes % W
            nb = ((y - dy) % H) * W + (x - dx) % W
            cand_d, cand_i = dep[nb], img[nb]
            fill = cand_d > 0
            dep[holes[fill]] = cand_d[fill]
            img[holes[fill]] = cand_i[fill]
            holes = holes[~fill]
    return img.reshape(H, W, 3), dep.reshape(H, W)


def render_frames(cfg, seed, n_frames, motion_scale, loop_period=0):
    """Every frame of a run, rendered up front: (images (n,H,W,3) float32,
    depths (n,H,W) float32, c2w (n,4,4) float32)."""
    H, W, fx, fy, cx, cy = camera(cfg)
    points, colors = build_scene(seed, H, W, fx, fy, cx, cy)
    poses = trajectory(n_frames, motion_scale, loop_period)
    images = np.empty((n_frames, H, W, 3), np.float32)
    depths = np.empty((n_frames, H, W), np.float32)

    def one(k):
        images[k], depths[k] = render(points, colors, poses[k], H, W, fx,
                                      fy, cx, cy)

    # numpy's sort and indexing release the interpreter lock: the frames
    # render side by side, each exactly as alone
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(one, range(n_frames)))
    return images, depths, poses.astype(np.float32)


class Stream:
    """The frames of a run as the program reads a dataset: `stream[k]` is
    (k, image (H,W,3) float32, depth (H,W), c2w (4,4)), and
    `get_intrinsic()` the output frames' (fx, fy, cx, cy)."""

    def __init__(self, cfg, images, depths, c2w):
        self.images, self.depths, self.c2w = images, depths, c2w
        _, _, fx, fy, cx, cy = camera(cfg)
        self.intrinsic = np.asarray([fx, fy, cx, cy], np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, k):
        return k, self.images[k], self.depths[k], self.c2w[k]

    def get_intrinsic(self):
        return self.intrinsic
