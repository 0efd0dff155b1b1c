"""Convex 8× upsampling of disparity fields (counterpart of
splatslam_tpu/ops/upsample.py). Mask channel layout matches the torch
view(batch, 1, 9, 8, 8, ht, wd): channel c = ((m·8 + sy)·8 + sx) with
neighbor m = ky·3 + kx."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighbors(data):
    """data (B,H,W,C) → the 3×3 zero-padded neighborhood (B,H,W,9,C)."""
    B, H, W, C = data.shape
    padded = F.pad(data, (0, 0, 1, 1, 1, 1))
    return torch.stack([padded[:, ky:ky + H, kx:kx + W]
                        for ky in range(3) for kx in range(3)], 3)


def cvx_upsample(data, mask):
    """data (B, H, W, C); mask (B, H, W, 576) → (B, 8H, 8W, C)."""
    B, H, W, C = data.shape
    m = torch.softmax(mask.reshape(B, H, W, 9, 8, 8), dim=3)
    up = torch.einsum("bhwnyx,bhwnc->bhwyxc", m, _neighbors(data))
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * H, 8 * W, C)


def upsample_disp(disp, mask):
    """disp (B, H, W); mask (B, H, W, 576) → (B, 8H, 8W)."""
    return cvx_upsample(disp[..., None], mask)[..., 0]


def upsample_disp_uniform(disp):
    """Zero-mask cvx_upsample computed directly: every 8×8 sub-pixel gets
    the 3×3 neighborhood mean (the oracle tracking path)."""
    B, H, W = disp.shape
    neigh = _neighbors(disp[..., None])[..., 0].sum(3) / 9.0
    up = neigh[:, :, None, :, None].expand(B, H, 8, W, 8)
    return up.reshape(B, 8 * H, 8 * W)
