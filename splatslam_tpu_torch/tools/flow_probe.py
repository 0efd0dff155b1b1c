"""Iterated-flow EPE of a tracker checkpoint on the bench scene (the port's
counterpart of tools/flow_probe.py; same scene, pairs and printed lines).

Renders smoke-geometry frame pairs (240x320, fx 200, motion_scale 5) at
frame gaps 1, 2, 3, 5, 8 from frames 5, 15, 25 and 40, runs 8
update-operator iterations in float32 (the motion filter's track loop) and
prints per gap:

  gap G: gt_flow <mean GT flow px>  epe <mean endpoint error px>
         first_delta <mean |delta| of iteration 1>  mag_bias <signed px>

epe << gt_flow means the net tracks; epe ~= gt_flow that it predicts near
zero motion. first_delta is what `motion_filter.thresh` compares against;
a negative mag_bias is flow the net underestimates.

Usage: python -m splatslam_tpu_torch.tools.flow_probe [ckpt.msgpack]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..models.droid_net import normalize_images
from ..models.weights import load_selftrained
from ..ops import corr as corr_ops
from ..ops import lie
from ..ops import projective as pops
from ._scene import DEFAULT_CKPT, scene_cfg

GAPS = (1, 2, 3, 5, 8)
STARTS = (5, 15, 25, 40)


@torch.no_grad()
def probe_pair(model, img1, img2, disp8, pose1, pose2, intr8, iters=8):
    """One frame pair: images (H,W,3) float [0,1], disp8 (h,w) the first
    frame's 1/8 disparity, poses w2c 7-vectors, intr8 the 1/8 intrinsics.
    Returns (epe, gt_flow, first_delta, mag_bias) as floats, each a mean
    over the pixels the GT flow keeps valid (first_delta over all)."""
    dev = model.device
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                     device=dev)
    x = normalize_images(torch.stack([as_t(img1), as_t(img2)]))
    fmaps = model.features(x)
    cn, ci = model.context(x[:1])
    h, w = fmaps.shape[-2:]
    coords0 = pops.coords_grid(h, w, device=dev)
    pyr = corr_ops.build_corr_pyramid(fmaps[:1].float(), fmaps[1:].float())
    ii = torch.tensor([0], device=dev)
    jj = torch.tensor([1], device=dev)
    gt, valid = pops.projective_transform(
        torch.stack([as_t(pose1), as_t(pose2)])[None],
        as_t(disp8)[None, None].expand(1, 2, h, w),
        as_t(intr8)[None, None].expand(1, 2, 4), ii, jj)
    gt, valid = gt[0, 0], valid[0, 0, ..., 0]
    net = cn
    coords = coords0[None]
    first_delta = None
    for _ in range(iters):
        corr = corr_ops.lookup_pyramid(pyr, coords)
        motn = torch.cat([torch.clamp(coords - coords0, -64, 64),
                          torch.zeros_like(coords)], -1).permute(0, 3, 1, 2)
        net, delta, _ = model.update_step(net, ci, corr, motn)
        delta = delta.float().permute(0, 2, 3, 1)
        if first_delta is None:
            first_delta = delta.norm(dim=-1).mean()
        coords = coords + delta
    n = torch.clamp(valid.sum(), min=1)
    err = (coords[0] - gt).norm(dim=-1) * valid
    gtmag = (gt - coords0).norm(dim=-1) * valid
    estmag = (coords[0] - coords0).norm(dim=-1) * valid
    return (float(err.sum() / n), float(gtmag.sum() / n), float(first_delta),
            float((estmag - gtmag).sum() / n))


def pair_inputs(ds, k0, gap, intr8):
    """The probe's inputs for frames (k0, k0 + gap) of dataset `ds`."""
    _, im1, d1, c1 = ds[k0]
    _, im2, _, c2 = ds[k0 + gap]
    h, w = d1.shape[0] // 8, d1.shape[1] // 8
    d8 = d1[3::8, 3::8][:h, :w]
    disp8 = np.where(d8 > 1e-6, 1.0 / np.maximum(d8, 1e-6), 0.0)
    p1 = lie.from_matrix_np(np.linalg.inv(c1))
    p2 = lie.from_matrix_np(np.linalg.inv(c2))
    return im1, im2, disp8.astype(np.float32), p1, p2, intr8


def probe(model, ds, gaps=GAPS, starts=STARTS):
    """{gap: (gt_flow, epe, first_delta, mag_bias)}, each the mean over the
    pairs that start at `starts`."""
    intr = np.asarray(ds.get_intrinsic(), np.float32)
    intr8 = intr / 8.0
    out = {}
    for gap in gaps:
        vals = np.asarray([probe_pair(model, *pair_inputs(ds, k0, gap, intr8))
                           for k0 in starts])
        e, g, f, b = vals.mean(0)
        out[gap] = (float(g), float(e), float(f), float(b))
    return out


def format_line(gap, gt_flow, epe, first_delta, bias):
    return (f"gap {gap}: gt_flow {gt_flow:6.2f} px  "
            f"epe {epe:6.3f} px  "
            f"first_delta {first_delta:5.2f} px  "
            f"mag_bias {bias:+6.3f} px")


def load_model(ckpt, device):
    """The checkpoint as a float32 network without gradients."""
    return load_selftrained(ckpt, device=device).requires_grad_(False).eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt", nargs="?", default=DEFAULT_CKPT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from ..datasets import Synthetic
    model = load_model(args.ckpt, resolve_device(args.device))
    ds = Synthetic(scene_cfg())
    res = {}
    for gap in GAPS:
        res.update(probe(model, ds, gaps=(gap,)))
        print(format_line(gap, *res[gap]), flush=True)
    return res


if __name__ == "__main__":
    main()
