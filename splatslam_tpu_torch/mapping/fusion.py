"""Proxy-depth fusion and the batched map deformation (counterpart of
splatslam_tpu/mapping/fusion.py).

Reference src/mapper.py:258-301 (get_w2c_and_depth) erodes and inpaints
the mono prior on the CPU; here, as in the JAX package, the refresh is
batched tensor code:
  * outlier masking + 5× binary erosion = iterated 3×3 min-pool with the
    border padded True (scipy binary_erosion parity);
  * hole inpainting = push-pull pyramid fill (a smooth stand-in for
    cv2.INPAINT_NS);
  * mono→multiview scale/shift = the closed-form weighted LSQ;
and deform_points_batch moves the Gaussians of every refreshed keyframe
at once (mapper.py:154-255 update_mapping_points semantics).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import lie
from ..ops.ba import align_scale_and_shift
from . import gaussians as G


def _erode3(m):
    """One 3×3 binary erosion of (B,H,W) bool, border padded True."""
    mp = F.pad(m.float()[:, None], (1, 1, 1, 1), value=1.0)
    return (-F.max_pool2d(-mp, 3, stride=1))[:, 0] > 0.5


def _sum_pool2(x):
    """2×2 stride-2 sum pool of (B,H,W), zero-padding an odd edge at the
    end (reduce_window 'SAME' parity)."""
    B, H, W = x.shape
    x = F.pad(x, (0, W % 2, 0, H % 2))
    return x.reshape(B, (H + 1) // 2, 2, (W + 1) // 2, 2).sum((2, 4))


def push_pull_fill(x):
    """Fill x == 0 pixels of (B,H,W) with a smooth interpolation of the
    x > 0 pixels: average-pool (value·weight, weight) pyramids down to
    ~4 px, then upsample the coarse fill and keep finer data where it
    exists."""
    w = (x > 0).to(x.dtype)
    v, ww = x * w, w
    vals, wts = [v], [ww]
    while min(v.shape[-2], v.shape[-1]) > 4:
        v, ww = _sum_pool2(v), _sum_pool2(ww)
        vals.append(v)
        wts.append(ww)
    fill = vals[-1] / torch.clamp(wts[-1], min=1e-6)
    for lvl in range(len(vals) - 2, -1, -1):
        v, ww = vals[lvl], wts[lvl]
        up = F.interpolate(fill[:, None], size=v.shape[-2:], mode="bilinear",
                           align_corners=False)[:, 0]
        fill = torch.where(ww > 0, v / torch.clamp(ww, min=1e-6), up)
    return fill


def fuse_proxy_depth(disps_up, valid_mask, poses_w2c, monos, has_mono,
                     erosion_iters: int = 5):
    """Batched proxy-depth fusion. disps_up (B,H,W) upsampled tracker
    disparities; valid_mask (B,H,W) bool; poses_w2c (B,7); monos (B,H,W)
    raw mono-prior depth; has_mono (B,) bool.

    Returns (fused (B,H,W), w2c (B,4,4), scale (B,), shift (B,),
    invalid (B,) bool)."""
    est = 1.0 / torch.clamp(disps_up, min=1e-8)
    est = torch.where(valid_mask, est, torch.zeros_like(est))
    invalid = valid_mask.sum(dim=(1, 2)) < 100

    # outlier mask: mono > 4·mean over ALL pixels (mapper.py:277)
    mono_mean = monos.mean(dim=(1, 2), keepdim=True)
    mono = torch.where(monos > 4.0 * mono_mean, torch.zeros_like(monos),
                       monos)
    m = mono > 0
    for _ in range(erosion_iters):
        m = _erode3(m)
    mono = torch.where(m, mono, torch.zeros_like(mono))
    mono_filled = push_pull_fill(mono)

    sc, sh, _ = align_scale_and_shift(mono_filled, est,
                                      (m & valid_mask).float())
    do = has_mono & ~invalid
    sc = torch.where(do, sc, torch.ones_like(sc))
    sh = torch.where(do, sh, torch.zeros_like(sh))
    mono_wq = mono_filled * sc[:, None, None] + sh[:, None, None]
    fused = torch.where(valid_mask, est, mono_wq)
    fused = torch.where(do[:, None, None], fused, est)
    return fused, lie.to_matrix(poses_w2c), sc, sh, invalid


@torch.no_grad()
def deform_points_batch(st: G.GaussianState, frame_ids, w2c_new, w2c_old,
                        depth_new, depth_old, intrinsics, rigid):
    """Deform the Gaussians anchored to each refreshed keyframe (slots are
    disjoint by kf_id, so one pass is exact).

    frame_ids (D,) long; w2c_new/old (D,4,4); depth_new/old (D,H,W);
    rigid (D,) bool (invalid new depth → rigid move only)."""
    fx, fy, cx, cy = intrinsics.unbind(0)
    Hd, Wd = depth_new.shape[1:]
    eq = frame_ids[None, :] == st.kf_id[:, None].long()       # (C, D)
    found = eq.any(1) & st.alive
    slot = torch.argmax(eq.to(torch.int8), 1)
    Wo = w2c_old[slot]
    rig = rigid[slot]

    cam_old = torch.einsum("cij,cj->ci", Wo[:, :3, :3], st.xyz) + Wo[:, :3, 3]
    z = torch.clamp(cam_old[:, 2], min=1e-6)
    u = fx * cam_old[:, 0] / z + cx
    v = fy * cam_old[:, 1] / z + cy
    ui = torch.clamp(u.to(torch.int32), 0, Wd - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, Hd - 1).long()
    d_new = depth_new[slot, vi, ui]
    d_old = depth_old[slot, vi, ui]

    rescale = 1.0 + (d_new - d_old) / z
    # out-of-frustum / behind-camera points move rigidly
    oob = ((cam_old[:, 2] <= 1e-6) | (u < 0) | (u > Wd - 1)
           | (v < 0) | (v > Hd - 1))
    bad = (d_new == 0) | (d_old == 0) | (rescale <= 0.0) | rig | oob
    rescale = torch.where(bad, torch.ones_like(rescale), rescale)

    cam_scaled = cam_old * rescale[:, None]
    c2w_new = torch.linalg.inv(w2c_new)
    Trel = c2w_new @ w2c_old
    Cn = c2w_new[slot]
    moved = torch.einsum("cij,cj->ci", Cn[:, :3, :3], cam_scaled) \
        + Cn[:, :3, 3]
    new_xyz = torch.where(found[:, None], moved, st.xyz)

    # rotate quaternions (wxyz) by each keyframe's relative transform
    q_rel = lie.matrix_to_quat(Trel[:, :3, :3])               # xyzw
    qr = torch.cat([q_rel[:, 3:4], q_rel[:, :3]], -1)[slot]
    w1, x1, y1, z1 = qr.unbind(-1)
    w2, x2, y2, z2 = st.rotation.unbind(-1)
    q_new = torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)
    st = st.replace(
        xyz=new_xyz,
        rotation=torch.where(found[:, None], q_new, st.rotation),
        scaling=torch.where(found[:, None],
                            st.scaling + torch.log(rescale)[:, None],
                            st.scaling))
    # the reference zeroes the Adam moments of every replaced tensor
    return G._zero_moments(st, found)
