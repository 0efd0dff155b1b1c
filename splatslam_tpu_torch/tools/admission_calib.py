"""Keyframe admission density per `motion_filter.thresh` (the port's
counterpart of tools/admission_calib.py; same scene, thresholds and printed
lines).

Runs the motion filter's track_kernel (one update-operator step against the
last admitted keyframe, tracking/motion_filter.py) over the 60-frame bench
scene in the network's hot-path dtype for each threshold and prints
admitted/total, the median gap and the delta percentiles. The threshold that
matches oracle admission density (~27/60 at 1.0 GT px on this scene) is
checkpoint-dependent: re-measure it whenever pretrained/*.msgpack changes.

Usage: python -m splatslam_tpu_torch.tools.admission_calib [ckpt.msgpack]
           [thresh ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..models.droid_net import compute_dtype
from ..models.weights import load_selftrained
from ..tracking.motion_filter import (encode_context, encode_features,
                                      track_kernel)
from ._scene import DEFAULT_CKPT, scene_cfg

THRESHES = (1.2, 1.4, 1.6, 1.8)


def admission(model, frames, thresh):
    """The admission chain over `frames` (tensors (H,W,3) float [0,1] on the
    model's device) at `thresh`: (admitted frame indices, the mean delta of
    every frame after the first against the last admitted one)."""
    fmap = encode_features(model, frames[0])
    net, inp = encode_context(model, frames[0])
    admitted, deltas = [0], []
    for i in range(1, len(frames)):
        gmap, dmag = track_kernel(model, frames[i], fmap, net, inp)
        d = float(dmag)
        deltas.append(d)
        if d > thresh:
            admitted.append(i)
            fmap = gmap
            net, inp = encode_context(model, frames[i])
    return admitted, deltas


def format_line(thresh, admitted, deltas, n_frames):
    gaps = np.diff(admitted)
    return (f"thresh {thresh:4.2f}: admitted {len(admitted)}/{n_frames}  "
            f"median_gap {np.median(gaps) if len(gaps) else 0:.1f}  "
            f"delta p10/p50/p90 {np.percentile(deltas, 10):.2f}/"
            f"{np.percentile(deltas, 50):.2f}/"
            f"{np.percentile(deltas, 90):.2f}")


def load_model(ckpt, device):
    """The checkpoint in the tracker's dtype (compute_dtype), no
    gradients."""
    model = load_selftrained(ckpt, device=device).requires_grad_(False)
    return model.eval().to(compute_dtype())


def scene_frames(ds, device):
    return [torch.as_tensor(np.asarray(ds[i][1]), device=device)
            for i in range(len(ds))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt", nargs="?", default=DEFAULT_CKPT)
    ap.add_argument("thresh", nargs="*", type=float)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from ..datasets import Synthetic
    device = resolve_device(args.device)
    model = load_model(args.ckpt, device)
    frames = scene_frames(Synthetic(scene_cfg()), device)
    res = {}
    for thresh in tuple(args.thresh) or THRESHES:
        res[thresh] = admission(model, frames, thresh)
        print(format_line(thresh, *res[thresh], len(frames)), flush=True)
    return res


if __name__ == "__main__":
    main()
