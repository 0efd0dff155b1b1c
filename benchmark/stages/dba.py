"""A stage-1 bundle-adjustment solve (`ops/ba.dba`, one problem: no scene
dimension).

  dba_gap     the solve worked out again in float64: the change it makes
              to where each edge's pixels reproject (relative L2 over the
              call's edges). Float64, because two float32 runs of one
              solve (atomic sums in another order) part by about as much
              as TF32 moves it: the float32 answer is itself only known to
              its rounding, amplified by the solve. The reprojection, not
              the raw pose and disparity updates: those move freely along
              the solve's weakly determined directions.

Control: the solve in TF32 and in bfloat16 storage. TF32 alone leaves the
solve within its own float32 spread: at these shapes its products run on
cuBLAS's small-N SIMT kernels, which TF32 does not reach, and its error
is that of its elementwise float32 arithmetic, for which the precision
below is bf16.
"""

from __future__ import annotations

import torch

from splatslam_tpu_torch.ops import ba as ba_ops

from ..check import _bf16, _rel, lower_precision
from ..probes import clone
from ..reference import ba as ref_ba
from ..reference import tracking as ref_tr

NUMBERS = ("dba_gap",)


def arm(slot, p):
    def wrap(orig):
        def f(poses, disps, intrinsics, target, weight, eta, sensor_disps,
              edges, iters=2, lm=1e-4, ep=0.1, motion_only=False):
            if slot.full or poses.dim() != 2:
                return orig(poses, disps, intrinsics, target, weight, eta,
                            sensor_disps, edges, iters, lm, ep, motion_only)
            cap = dict(poses=clone(poses), disps=clone(disps),
                       intrinsics=clone(intrinsics), target=clone(target),
                       weight=clone(weight), eta=clone(eta),
                       sensor=clone(sensor_disps), ii=clone(edges.ii),
                       jj=clone(edges.jj), t0=edges.t0, t1=edges.t1,
                       iters=iters, lm=lm, ep=ep, motion_only=motion_only)
            out = orig(poses, disps, intrinsics, target, weight, eta,
                       sensor_disps, edges, iters, lm, ep, motion_only)
            cap["out"] = clone(out)
            slot.put(cap)
            return out
        return f
    p.put(ba_ops, "dba", wrap)


def dba(cap, dtype=torch.float64):
    """The solve in `dtype` (float64 for the reference, float32 for the
    control), its result in float32."""
    edges = ref_ba.make_edges(cap["ii"], cap["jj"], cap["t0"], cap["t1"],
                              cap["ii"].device)
    c = lambda k: None if cap[k] is None else cap[k].to(dtype)
    poses, disps = ref_ba.dba(c("poses"), c("disps"), c("intrinsics"),
                              c("target"), c("weight"), c("eta"),
                              c("sensor"), edges, iters=cap["iters"],
                              lm=cap["lm"], ep=cap["ep"],
                              motion_only=cap["motion_only"])
    return poses.float(), disps.float()


def dba_gap(cap, prog, ref):
    ii, jj, intr = cap["ii"], cap["jj"], cap["intrinsics"]
    moved = lambda out: (ref_tr.reproject(out[0], out[1], intr, ii, jj)[0]
                         - ref_tr.reproject(cap["poses"], cap["disps"],
                                            intr, ii, jj)[0])
    return _rel(moved(prog), moved(ref))


@torch.no_grad()
def reference(ctx, cap):
    return dba(cap)


@torch.no_grad()
def gaps(cap, ref):
    return {"dba_gap": dba_gap(cap, cap["out"], ref)}


@torch.no_grad()
def control(ctx, cap, ref):
    with lower_precision():
        r = _bf16(dba(_bf16(cap), torch.float32))
    return {"dba_gap": dba_gap(cap, r, ref)}
