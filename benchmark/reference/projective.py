"""Frozen copy of the port's plain `ops/projective.py`, taken when the
benchmark was written, for the benchmark's reference: it imports nothing
of the program, so a later change to the program does not change it.

Pinhole projective geometry with analytic Jacobians, in PyTorch
(counterpart of splatslam_tpu/ops/projective.py; same math and Jacobian
conventions — left-perturbation SE3 tangent [tau, phi]).

Batched as (B, N, H, W, ...) with N the number of factor edges.
"""

from __future__ import annotations

import torch

from . import lie

MIN_DEPTH = 0.2


def coords_grid(ht: int, wd: int, dtype=torch.float32, device=None):
    """Pixel coordinate grid (ht, wd, 2) ordered (x, y)."""
    y = torch.arange(ht, dtype=dtype, device=device)
    x = torch.arange(wd, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], -1)


def iproj(disps, intrinsics, jacobian=False):
    """disps (B,N,H,W); intrinsics (B,N,4) → pts (B,N,H,W,4) [, J]."""
    B, N, H, W = disps.shape
    fx, fy, cx, cy = [intrinsics[..., i, None, None] for i in range(4)]
    grid = coords_grid(H, W, dtype=disps.dtype, device=disps.device)
    X = (grid[..., 0] - cx) / fx
    Y = (grid[..., 1] - cy) / fy
    ones = torch.ones_like(disps)
    pts = torch.stack([X * ones, Y * ones, ones, disps], -1)
    if jacobian:
        J = torch.zeros_like(pts)
        J[..., 3] = 1.0
        return pts, J
    return pts, None


def proj(Xs, intrinsics, jacobian=False, return_depth=False):
    fx, fy, cx, cy = [intrinsics[..., i, None, None] for i in range(4)]
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    coords = torch.stack([x, y, D * d] if return_depth else [x, y], -1)
    if jacobian:
        o = torch.zeros_like(d)
        r0 = torch.stack([fx * d, o, -fx * X * d * d, o], -1)
        r1 = torch.stack([o, fy * d, -fy * Y * d * d, o], -1)
        return coords, torch.stack([r0, r1], -2)
    return coords, None


def actp(Gij, X0, jacobian=False):
    X1 = lie.act(Gij[:, :, None, None, :], X0)
    if jacobian:
        X, Y, Z, d = X1.unbind(-1)
        o = torch.zeros_like(d)
        Ja = torch.stack([
            d, o, o, o, Z, -Y,
            o, d, o, -Z, o, X,
            o, o, d, Y, -X, o,
            o, o, o, o, o, o], -1).reshape(X1.shape[:-1] + (4, 6))
        return X1, Ja
    return X1, None


def projective_transform(poses, depths, intrinsics, ii, jj, jacobian=False,
                         return_depth=False):
    """Map pixels of frames ii into frames jj.

    poses (B,P,7) w2c; depths (B,P,H,W) disparities; intrinsics (B,P,4);
    ii/jj (N,) long. Returns (coords, valid[, (Ji, Jj, Jz)])."""
    X0, Jz = iproj(depths[:, ii], intrinsics[:, ii], jacobian=jacobian)
    Gij = lie.mul(poses[:, jj], lie.inv(poses[:, ii]))
    # self-edges get a fixed baseline (reference projective_ops.py:119)
    fixed = torch.tensor([-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                         dtype=Gij.dtype, device=Gij.device)
    Gij = torch.where((ii == jj)[None, :, None], fixed, Gij)
    X1, Ja = actp(Gij, X0, jacobian=jacobian)
    x1, Jp = proj(X1, intrinsics[:, jj], jacobian=jacobian,
                  return_depth=return_depth)
    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH))
    valid = valid.to(x1.dtype)[..., None]
    if jacobian:
        Jj = Jp @ Ja
        Ji = -lie.adjT_apply(Gij[:, :, None, None], Jj)
        Jz2 = lie.act(Gij[:, :, None, None, :], Jz)
        Jz2 = Jp @ Jz2[..., None]
        return x1, valid, (Ji, Jj, Jz2)
    return x1, valid


def induced_flow(poses, disps, intrinsics, ii, jj):
    H, W = disps.shape[-2:]
    coords0 = coords_grid(H, W, dtype=disps.dtype, device=disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid
