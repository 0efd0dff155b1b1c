"""Rendering evaluation: PSNR / SSIM / depth-L1 per mapped keyframe
(counterpart of splatslam_tpu/utils/eval_render.py; reference
src/utils/eval_utils.py:38-212).

LPIPS stays None, as in the JAX package (no pretrained AlexNet weights).
`eval_mesh` fuses the rendered keyframe depths into a TSDF on the device
and writes `mesh.ply`; `save_panels` writes a 2×3 RGB/depth/diff PNG per
keyframe (matplotlib) and a gif of the renders (PIL).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..mapping.losses import psnr, ssim


def _render_depth(out):
    """Alpha-normalised render depth (the raw accumulation sum(w_i d_i)
    understates depth wherever coverage alpha < 1); 0 where alpha ≤ 0.5."""
    return torch.where(out.alpha > 0.5,
                       out.depth / torch.clamp(out.alpha, min=1e-6),
                       torch.zeros_like(out.depth))


@torch.no_grad()
def fuse_keyframes(mapper, global_scale=1.0, voxel=5.0 / 512, trunc=0.04):
    """Render every mapped keyframe and fuse its alpha-normalised depth and
    colour into a TSDFVolume on the mapper's device (bounds from the camera
    centres and the proxy depth range, at most 256 voxels a side). Returns
    the volume, or None when no keyframe is mapped."""
    from .mesh import TSDFVolume
    cams = [mapper.viewpoints.get(k, mapper.cameras.get(k))
            for k in mapper.video_idxs if mapper.is_kf.get(k, False)]
    cams = [c for c in cams if c is not None]
    if not cams:
        return None
    centers = np.stack([np.linalg.inv(np.asarray(c.w2c))[:3, 3]
                        for c in cams])
    depths_max = max(float(c.depth.max()) if c.depth is not None else 3.0
                     for c in cams)
    # voxel/trunc are PHYSICAL metres; the map lives in estimate units where
    # 1 unit = global_scale metres, hence the division
    s = max(global_scale, 1e-6)
    vol = TSDFVolume(centers.min(0) - depths_max, centers.max(0) + depths_max,
                     voxel=voxel / s, trunc=trunc / s, max_dim=256,
                     device=mapper.device)
    intr = mapper.intrinsics.tolist()
    CH = 8
    for c0 in range(0, len(cams), CH):
        chunk = cams[c0:c0 + CH]
        out = mapper.render_batch(chunk)
        depth = _render_depth(out)
        color = torch.clamp(out.color, 0, 1)
        for i, cam in enumerate(chunk):
            vol.integrate(depth[i], color[i], np.asarray(cam.w2c), intr)
    return vol


def eval_mesh(mapper, save_dir, global_scale=1.0, gt_mesh_path="",
              printer=None, voxel=5.0 / 512, trunc=0.04):
    """TSDF-fuse rendered keyframe depths → mesh.ply (+ F-score against a
    ground-truth mesh when one is given) — eval_utils.py:70-73,137-187."""
    from .mesh import save_mesh_ply, load_mesh_ply, run_evaluation, clean_mesh
    vol = fuse_keyframes(mapper, global_scale, voxel, trunc)
    if vol is None:
        return None
    verts, faces = vol.extract_mesh()
    n0 = len(verts)
    verts, faces, _ = clean_mesh(verts, faces)   # eval_utils.py:331-378
    os.makedirs(save_dir, exist_ok=True)
    save_mesh_ply(os.path.join(save_dir, "mesh.ply"), verts, faces)
    result = {"n_verts": int(len(verts)), "n_faces": int(len(faces)),
              "n_verts_raw": int(n0)}
    if gt_mesh_path and os.path.exists(gt_mesh_path):
        gt_v, gt_f = load_mesh_ply(gt_mesh_path)
        if global_scale != 1.0:
            verts = verts * global_scale
        result.update(run_evaluation(verts, faces, gt_v, gt_f,
                                     distance_thresh=0.05, icp=True))
    if printer:
        printer.print(f"mesh eval: {result}")
    return result


def plot_rgbd_panel(gt, pred, gt_depth, pred_depth, psnr_score, depth_l1,
                    path):
    """2×3 RGB/depth/diff panel per keyframe (reference
    eval_utils.py:130-168 plot_rgbd_silhouette)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(2, 3, figsize=(12, 6))
    diff_rgb = np.abs(gt - pred).mean(-1)
    diff_d = np.abs(gt_depth - pred_depth) * (gt_depth > 0)
    for a, (im, title, kw) in zip(ax.flat, [
            (gt, "GT rgb", {}),
            (pred, f"render (psnr {psnr_score:.2f})", {}),
            (diff_rgb, "|rgb diff|", dict(cmap="jet")),
            (gt_depth, "GT depth", dict(cmap="jet")),
            (pred_depth, "render depth", dict(cmap="jet")),
            (diff_d, f"|depth diff| (L1 {depth_l1:.3f})",
             dict(cmap="jet"))]):
        a.imshow(im, **kw)
        a.set_title(title)
        a.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)


def _write_gif(frames, path):
    """Animated gif of the rendered keyframes (eval_utils gif output)."""
    from PIL import Image
    ims = [Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8))
           for f in frames]
    if ims:
        ims[0].save(path, save_all=True, append_images=ims[1:],
                    duration=120, loop=0)


@torch.no_grad()
def eval_rendering(mapper, save_dir, stream, global_scale=1.0,
                   iteration="after_refine", printer=None,
                   save_panels=True):
    """Render every mapped keyframe in chunks of 8, correct exposure, and
    aggregate PSNR (over GT > 0), SSIM and the alpha-normalised render
    depth L1 against GT depth. `save_panels` also writes a 2×3
    RGB/depth/diff PNG per keyframe and a gif of the renders under
    `plots_<iteration>/`."""
    img_dir = os.path.join(save_dir, "rendering", iteration)
    os.makedirs(img_dir, exist_ok=True)
    plot_dir = os.path.join(save_dir, f"plots_{iteration}")
    if save_panels:
        os.makedirs(plot_dir, exist_ok=True)
    gif_frames = []
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
        chunk_psnr = [float(psnr(im, gt, gt > 0))
                      for im, gt in zip(images, gt_stack)]
        psnrs.extend(chunk_psnr)
        ssims.extend(float(ssim(im, gt)) for im, gt in zip(images, gt_stack))
        dep_np = _render_depth(out).cpu().numpy() * global_scale
        img_np = images.cpu().numpy() if save_panels else None
        for i, (kf_idx, frame_idx) in enumerate(chunk):
            gt_depth = gts[i][2]
            d_l1 = float("nan")
            if gt_depth is not None:
                gt_depth = np.asarray(gt_depth)
                m = (gt_depth > 0) & (dep_np[i] > 0)
                if m.sum():
                    d_l1 = float(np.abs(dep_np[i][m] - gt_depth[m]).mean())
                    depth_l1s.append(d_l1)
            if save_panels:
                gtd = (gt_depth if gt_depth is not None
                       else np.zeros(dep_np[i].shape))
                plot_rgbd_panel(
                    np.asarray(gts[i][1]), img_np[i], gtd, dep_np[i],
                    chunk_psnr[i], 0.0 if np.isnan(d_l1) else d_l1,
                    os.path.join(
                        plot_dir,
                        f"video_idx_{kf_idx}_kf_idx_{frame_idx}.png"))
                gif_frames.append(img_np[i])

    if save_panels and gif_frames:
        _write_gif(gif_frames, os.path.join(plot_dir, "renders.gif"))

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
