"""Frozen copy of the port's plain `mapping/losses.py`, taken when the
benchmark was written, for the benchmark's reference: it imports nothing
of the program, so a later change to the program does not change it.

Mapping losses and image metrics (counterpart of
splatslam_tpu/mapping/losses.py; reference
thirdparty/monogs/utils/slam_utils.py:80-119,
thirdparty/gaussian_splatting/utils/loss_utils.py:42-101). Channel-last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(a, b):
    return (a - b).abs().mean()


def _gaussian_1d(size, sigma, device):
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(img1, img2, window_size=11):
    """SSIM of (H, W, C) images in [0, 1]: zero-padded separable 11×11
    gaussian window (sigma 1.5), as conv2d with padding 5 in the
    reference."""
    C = img1.shape[-1]
    g = _gaussian_1d(window_size, 1.5, img1.device)
    kh = g.view(1, 1, -1, 1).expand(C, 1, window_size, 1)
    kw = g.view(1, 1, 1, -1).expand(C, 1, 1, window_size)
    pad = window_size // 2

    def filt(x):
        x = x.permute(2, 0, 1)[None]
        x = F.conv2d(x, kh, padding=(pad, 0), groups=C)
        x = F.conv2d(x, kw, padding=(0, pad), groups=C)
        return x[0].permute(1, 2, 0)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean()


def mapping_loss(image, depth, gt_image, gt_depth, alpha=0.8,
                 rgb_boundary_threshold=0.01, use_ssim=False,
                 lambda_dssim=0.2):
    """get_loss_mapping_rgbd (slam_utils.py:80-105), batched over a
    leading camera dim: image/gt_image (B,H,W,3), depth/gt_depth (B,H,W).
    Returns (B,) per-camera losses."""
    rgb_mask = (gt_image.sum(-1) > rgb_boundary_threshold)[..., None]
    l1_rgb = (image * rgb_mask - gt_image * rgb_mask).abs()
    loss_rgb = l1_rgb.mean(dim=(1, 2, 3))
    if use_ssim:
        ss = torch.stack([ssim(a, b) for a, b in zip(image, gt_image)])
        loss_rgb = (1 - lambda_dssim) * loss_rgb + lambda_dssim * (1.0 - ss)
    depth_mask = gt_depth > 0.01
    l1_depth = (depth * depth_mask - gt_depth * depth_mask).abs()
    return alpha * loss_rgb + (1 - alpha) * l1_depth.mean(dim=(1, 2))


