"""Inputs for DSPO stage 2's kernels (csrc/dspo.cu), made from a seed with
numpy: the tracker's shapes, and the inputs a kernel design can get wrong.
The card tests and chip_smoke.py hold the kernels against their plain
versions on them; the CPU tests hold the dispatch to the plain versions.

The scene is a slanted plane seen by a slowly moving camera, so that
reprojections land inside and outside the image and the multiview filter
finds agreeing and disagreeing neighbours.

    make_problem(name) -> dict(poses (B,7), disps (B,h,w), intrinsics (4,),
        target/weight (E,h,w,2), eta (M,h,w), mono_disps (B,h,w),
        scales/shifts (B,), valid_depth_mask (B,h,w) bool, edges (EdgeSet),
        lm, ep, alpha, kx_mask (M,) bool or None), CPU tensors
    make_filter_problem(name) -> dict(poses, disps, intrinsics, inds,
        thresh), CPU tensors
"""

from __future__ import annotations

import numpy as np
import torch

from splatslam_tpu_torch.ops import ba, projective

CASES = (
    "replica",      # 40x80, E = 100 edges, M = 40 depth frames (the
                    # replica_scale cell's round), kx_mask partial
    "loop",         # 48x64, a loop-closure edge set: window neighbours and
                    # edges i - j > 20 both ways, so most depth frames lie
                    # before t0; kx_mask None
    "hard",         # 24x32: a depth frame with no outgoing edge, ii == jj
                    # self-edges, jj outside [t0, t1), mono < 1e-6 on a share
                    # of the pixels and on a whole frame; kx_mask partial
    "singular",     # "hard" with ep = lm = 0: the frame without a prior has
                    # the 2x2 system 0 (det 0, no step)
    "nonfinite",    # "replica" at 24x32 with a NaN target in one edge: its
                    # frame's dz is not finite and the frame keeps its state
)

FILTER_CASES = (
    "eighth",       # 40x80 buffer of 60, the round's 40 frames and the
                    # buffer's first and last three (neighbours outside it)
    "full",         # 320x640 (valid_depth_masks at full resolution), 5
                    # frames, the first and the last of the buffer among them
)


def _quat(axis_angle):
    th = np.linalg.norm(axis_angle)
    if th < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    a = axis_angle / th
    return np.concatenate([a * np.sin(th / 2), [np.cos(th / 2)]])


def _rot(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _scene(rng, B, h, w):
    """w2c poses (B,7) along a slow path, intrinsics (4,) and the plane's
    disparities (B,h,w) with 1 % noise."""
    f = 0.6 * w
    intr = np.array([f, f, (w - 1) / 2, (h - 1) / 2])
    poses = np.zeros((B, 7))
    disps = np.zeros((B, h, w))
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(u - intr[2]) / f, (v - intr[3]) / f, np.ones_like(u)],
                    -1)
    n = np.array([0.1, -0.2, 1.0])
    for k in range(B):
        q = _quat(np.array([0.004 * k, 0.01 * np.sin(0.3 * k), 0.002 * k]))
        R = _rot(q)
        c = np.array([0.02 * k, 0.005 * np.sin(0.5 * k), 0.01 * k])
        poses[k, :3] = -R @ c
        poses[k, 3:] = q
        # depth s along camera z: n . (c + s R^T r) = 3
        dirs = rays @ R
        s = (3.0 - n @ c) / (dirs @ n)
        disps[k] = (1.0 / s) * (1.0 + 0.01 * rng.randn(h, w))
    return poses, intr, disps


def _edges(name, rng):
    """(B, h, w, ii, jj, t0, t1) of a case."""
    if name in ("replica", "nonfinite"):
        B, t0, t1 = 60, 10, 50
        h, w = (40, 80) if name == "replica" else (24, 32)
        pairs = [(i, j) for i in range(t0, t1) for j in range(i - 3, i + 4)
                 if j != i and 0 <= j < B]
        sel = rng.choice(len(pairs), 100, replace=False)
        ii, jj = np.asarray([pairs[s] for s in np.sort(sel)]).T
        return B, h, w, ii, jj, t0, t1
    if name == "loop":
        B, t0, t1 = 80, 40, 60
        near = [(i, j) for i in range(t0 - 3, t1) for j in range(i - 2, i + 3)
                if j != i and 0 <= j < t1]
        loop = [(i, j) for i in range(45, 60, 2) for j in range(5, 20, 3)]
        loop += [(j, i) for i, j in loop]
        ii, jj = np.asarray(near + loop).T
        return B, 48, 64, ii, jj, t0, t1
    # hard, singular: frame 9 in [t0, t1) has no outgoing edge; (5, 5) and
    # (7, 7) are self-edges; 2 and 14 lie outside [4, 12); 3 < t0
    B, t0, t1 = 16, 4, 12
    e = [(3, 4), (4, 5), (5, 4), (5, 5), (5, 6), (6, 5), (6, 2), (7, 7),
         (7, 6), (8, 7), (8, 14), (8, 9), (10, 9), (10, 11), (11, 10),
         (4, 2), (6, 7)]
    ii, jj = np.asarray(e).T
    return B, 24, 32, ii, jj, t0, t1


def make_problem(name, seed=0, buffer=None):
    """`buffer`: the keyframe buffer's size B, when above the case's (the
    cells' buffers hold 400 or 600 frames; an iteration copies all of it)."""
    if name not in CASES:
        raise KeyError(name)
    rng = np.random.RandomState(seed + CASES.index(name))
    B, h, w, ii, jj, t0, t1 = _edges(name, rng)
    ii, jj = np.array(ii), np.array(jj)
    poses, intr, disps = _scene(rng, B, h, w)
    if buffer is not None and buffer > B:
        poses = np.concatenate([poses, np.repeat(poses[-1:], buffer - B, 0)])
        disps = np.concatenate([disps, np.ones((buffer - B, h, w))])
        B = buffer
    t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt)
    poses_t, disps_t, intr_t = t(poses), t(disps), t(intr)
    edges = ba.make_edges(ii, jj, t0, t1)
    E, M = len(ii), edges.M
    coords, _ = projective.projective_transform(
        poses_t[None], disps_t[None], intr_t.expand(B, 4)[None],
        edges.ii, edges.jj)
    target = coords[0] + t(0.5 * rng.randn(E, h, w, 2))
    if name == "nonfinite":
        target[7, 3, 5, 0] = float("nan")
    mono = disps * 0.9 + 0.05 + 0.02 * rng.randn(B, h, w)
    mono[rng.rand(B, h, w) < 0.05] = 0.0
    if name in ("hard", "singular"):
        mono[rng.rand(B, h, w) < 0.2] = 0.0
        mono[6] = 0.0
    kx_mask = None
    if name != "loop":
        kx_mask = t(rng.rand(M) < 0.7, torch.bool)
        kx_mask[0] = True
        if name in ("hard", "singular"):
            kx_mask[(edges.kx == 6).nonzero()[0, 0]] = True
    flat = name == "singular"
    return dict(
        poses=poses_t, disps=disps_t, intrinsics=intr_t, target=target,
        weight=t(rng.rand(E, h, w, 2)),
        eta=t(1e-4 + 1e-2 * rng.rand(M, h, w)), mono_disps=t(mono),
        scales=t(1.1 + 0.1 * rng.randn(B)), shifts=t(-0.05 + 0.02 *
                                                     rng.randn(B)),
        valid_depth_mask=t(rng.rand(B, h, w) < 0.7, torch.bool),
        edges=edges, lm=0.0 if flat else 1e-4, ep=0.0 if flat else 0.1,
        alpha=0.01, kx_mask=kx_mask)


def make_filter_problem(name, seed=0):
    if name not in FILTER_CASES:
        raise KeyError(name)
    rng = np.random.RandomState(100 + seed + FILTER_CASES.index(name))
    if name == "eighth":
        B, h, w = 60, 40, 80
        inds = list(range(10, 50)) + [0, 1, 2, 57, 58, 59]
    else:
        B, h, w = 12, 320, 640
        inds = [0, 3, 6, 10, 11]
    poses, intr, disps = _scene(rng, B, h, w)
    disps_t = torch.as_tensor(disps, dtype=torch.float32)
    inds_t = torch.as_tensor(inds, dtype=torch.long)
    depths = 1.0 / disps_t[inds_t]
    return dict(poses=torch.as_tensor(poses, dtype=torch.float32),
                disps=disps_t,
                intrinsics=torch.as_tensor(intr, dtype=torch.float32),
                inds=inds_t, thresh=0.01 * depths.mean(dim=(1, 2)))
