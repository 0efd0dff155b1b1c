"""The update operator over an edge set
(`tracking/factor_graph.update_operator`).

  update_gap  the flow revision, the confidence, the damping and the
              hidden state (relative L2, the largest of the four). The
              features and context of each keyframe the edges touch are
              encoded again from its frame, named by the keyframes'
              timestamps in the program's DepthVideo at the call.

Control: the network's bf16 convolutions in fp8 e4m3 with a per-tensor
scale, the float32 matmuls of the correlation in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from splatslam_tpu_torch.tracking import factor_graph as fg_mod

from ..check import _rel, lower_precision
from ..probes import clone
from ..reference import tracking as ref_tr

NUMBERS = ("update_gap",)


def arm(slot, p):
    def wrap(orig):
        def f(model, poses, disps, intrinsics, fmaps, inps, net, target,
              ii, jj, pyramid=None):
            if slot.full:
                return orig(model, poses, disps, intrinsics, fmaps, inps,
                            net, target, ii, jj, pyramid)
            cap = dict(poses=clone(poses), disps=clone(disps),
                       intrinsics=clone(intrinsics), net=clone(net),
                       target=clone(target), ii=clone(ii), jj=clone(jj),
                       timestamps=clone(
                           slot.video.state.timestamp).cpu().numpy())
            out = orig(model, poses, disps, intrinsics, fmaps, inps, net,
                       target, ii, jj, pyramid)
            cap["out"] = clone(out)
            slot.put(cap)
            return out
        return f
    p.put(fg_mod, "update_operator", wrap)


def _u8(frame):
    """A frame as the loop hands it to the tracker: uint8 0-255."""
    return torch.as_tensor((np.asarray(frame) * 255.0).astype(np.uint8))


def update(model, cap, frames, device):
    """Reference outputs of the update operator."""
    ii, jj = cap["ii"], cap["jj"]
    rows = torch.unique(torch.cat([ii, jj])).tolist()
    n = cap["poses"].shape[0]
    imgs = torch.stack([_u8(frames[int(round(cap["timestamps"][r]))])
                        for r in rows]).to(device)
    f, _, inp = ref_tr.encode(model, imgs)
    fmaps = f.new_zeros((n,) + f.shape[1:])
    inps = inp.new_zeros((n,) + inp.shape[1:])
    idx = torch.as_tensor(rows, device=device)
    fmaps[idx], inps[idx] = f, inp
    return ref_tr.update_operator(model, cap["poses"], cap["disps"],
                                  cap["intrinsics"], fmaps, inps,
                                  cap["net"].float(), cap["target"], ii, jj)


def update_gap(prog, ref):
    net, target, weight, eta, _, _, coords1 = prog
    r_net, r_target, r_weight, r_eta, _, r_coords1 = ref
    return max(_rel(target - coords1, r_target - r_coords1),
               _rel(weight, r_weight), _rel(eta, r_eta), _rel(net, r_net))


@torch.no_grad()
def reference(ctx, cap):
    return update(ctx.droid, cap, ctx.frames, ctx.device)


@torch.no_grad()
def gaps(cap, ref):
    return {"update_gap": update_gap(cap["out"], ref)}


@torch.no_grad()
def control(ctx, cap, ref):
    with lower_precision(ctx.droid):
        r = update(ctx.droid, cap, ctx.frames, ctx.device)
    return {"update_gap": update_gap(r[:5] + (None, r[5]), ref)}
