"""The admission scan of a chunk (`tracking/motion_filter.admission_scan`).

  scan_gap    features and context of each frame (relative L2) and each
              frame's flow magnitude (largest error over the mean), under
              the program's own admissions.

Control: the network's bf16 convolutions in fp8 e4m3 with a per-tensor
scale, its float32 matmuls in TF32.
"""

from __future__ import annotations

import torch

from splatslam_tpu_torch.tracking import motion_filter as mf_mod

from ..check import _rel, lower_precision
from ..probes import clone
from ..reference import tracking as ref_tr

NUMBERS = ("scan_gap",)


def arm(slot, p):
    def wrap(orig):
        def f(model, images_u8, fmap0, net0, inp0, thresh):
            if slot.full:
                return orig(model, images_u8, fmap0, net0, inp0, thresh)
            cap = dict(images=clone(images_u8), fmap0=clone(fmap0),
                       net0=clone(net0), inp0=clone(inp0),
                       thresh=float(thresh))
            out = orig(model, images_u8, fmap0, net0, inp0, thresh)
            cap["out"] = clone(out)
            slot.put(cap)
            return out
        return f
    p.put(mf_mod, "admission_scan", wrap)


def scan(model, cap, device):
    """Reference outputs of the admission scan: (gmaps, nets, inps,
    deltas), the chain following the program's admissions."""
    gmaps, nets, inps = ref_tr.encode(model, cap["images"].to(device))
    admits = cap["out"][0][:gmaps.shape[0]] > 0.5
    fmap, net_c, inp_c = (cap["fmap0"].float(), cap["net0"].float(),
                          cap["inp0"].float())
    deltas = []
    for k in range(gmaps.shape[0]):
        deltas.append(ref_tr.flow_magnitude(model, fmap, gmaps[k], net_c,
                                            inp_c))
        if admits[k]:
            fmap, net_c, inp_c = gmaps[k], nets[k], inps[k]
    return gmaps, nets, inps, torch.stack(deltas)


def scan_gap(prog, ref):
    pack, gmaps, nets, inps = prog
    C = gmaps.shape[0]
    d_ref = ref[3]
    d_err = float((pack[C:] - d_ref).abs().max()
                  / torch.clamp(d_ref.abs().mean(), min=1e-30))
    return max(_rel(gmaps, ref[0]), _rel(nets, ref[1]), _rel(inps, ref[2]),
               d_err)


@torch.no_grad()
def reference(ctx, cap):
    return scan(ctx.droid, cap, ctx.device)


@torch.no_grad()
def gaps(cap, ref):
    return {"scan_gap": scan_gap(cap["out"], ref)}


@torch.no_grad()
def control(ctx, cap, ref):
    with lower_precision(ctx.droid):
        r = scan(ctx.droid, cap, ctx.device)
    C = r[0].shape[0]
    pack = torch.cat([torch.zeros(C, device=ctx.device), r[3]])
    return {"scan_gap": scan_gap((pack,) + tuple(r[:3]), ref)}
