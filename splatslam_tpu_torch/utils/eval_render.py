"""Rendering evaluation: PSNR / SSIM / depth-L1 per mapped keyframe
(counterpart of splatslam_tpu/utils/eval_render.py; reference
src/utils/eval_utils.py:38-212).

LPIPS stays None, as in the JAX package (no pretrained AlexNet weights).
Per-keyframe panels and the gif are not ported yet; `final_result.json`
is written with the same keys.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..mapping.losses import psnr, ssim


@torch.no_grad()
def eval_rendering(mapper, save_dir, stream, global_scale=1.0,
                   iteration="after_refine", printer=None):
    """Render every mapped keyframe in chunks of 8, correct exposure, and
    aggregate PSNR (over GT > 0), SSIM and the alpha-normalised render
    depth L1 against GT depth."""
    img_dir = os.path.join(save_dir, "rendering", iteration)
    os.makedirs(img_dir, exist_ok=True)
    kfs = [(k, f) for k, f in zip(mapper.video_idxs, mapper.keyframe_idxs)
           if mapper.is_kf.get(k, False)
           and mapper.viewpoints.get(k, mapper.cameras.get(k)) is not None]
    dev = mapper.device
    psnrs, ssims, depth_l1s = [], [], []
    CH = 8
    for c0 in range(0, len(kfs), CH):
        chunk = kfs[c0:c0 + CH]
        cams = [mapper.viewpoints.get(k, mapper.cameras.get(k))
                for k, _ in chunk]
        gts = [stream[f] for _, f in chunk]
        out = mapper.render_batch(cams)
        expo = torch.as_tensor(np.asarray([
            mapper.exp_ab.get(k, np.zeros(2))
            if k != mapper.first_mapped_uid else np.zeros(2)
            for k, _ in chunk], np.float32), device=dev)
        images = torch.clamp(torch.exp(expo[:, 0, None, None, None])
                             * out.color + expo[:, 1, None, None, None],
                             0.0, 1.0)
        gt_stack = torch.as_tensor(np.stack([np.asarray(g[1]) for g in gts]),
                                   dtype=torch.float32, device=dev)
        for im, gt in zip(images, gt_stack):
            psnrs.append(float(psnr(im, gt, gt > 0)))
            ssims.append(float(ssim(im, gt)))
        a_np = out.alpha.cpu().numpy()
        dep_np = np.where(a_np > 0.5, out.depth.cpu().numpy()
                          / np.clip(a_np, 1e-6, None), 0.0) * global_scale
        for i in range(len(chunk)):
            gt_depth = gts[i][2]
            if gt_depth is None:
                continue
            gt_depth = np.asarray(gt_depth)
            m = (gt_depth > 0) & (dep_np[i] > 0)
            if m.sum():
                depth_l1s.append(float(np.abs(dep_np[i][m]
                                              - gt_depth[m]).mean()))

    result = {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else None,
        "mean_ssim": float(np.mean(ssims)) if ssims else None,
        "mean_lpips": None,
        "mean_depth_l1": float(np.mean(depth_l1s)) if depth_l1s else None,
        "num_frames": len(psnrs),
        "lpips_note": ("unavailable (no pretrained AlexNet weights in this "
                       "environment)"),
    }
    with open(os.path.join(img_dir, "final_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    if printer:
        printer.print(f"render eval [{iteration}]: {result}")
    return result
