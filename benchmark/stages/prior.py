"""One pass of the monocular prior's network (`models/dpt.DPTDepthModel`,
the omnidata DPT-Hybrid): the first call after arming, its (1, 3, 512,
512) input and its output, and the model's weights, cloned on the device.

  prior_gap   the program's output against the plain reference's
              (reference/dpt.py) on the same input and weights, worked out
              on the device in float64: relative L2 over the whole
              output map (taken in float32, whose rounding, ~1e-7, lies
              far below the readings). Infinite, with no reference run,
              where the capture departs from the published network
              (`reference/dpt.departures`: a tensor missing, extra or of
              another shape, or an input other than 512x512), since the
              reference reads its widths from the weights it is given.

Control: the reference in float32 with TF32 matmuls and convolutions
(check.lower_precision) in the program's place; the configuration states
float32 with TF32 off.
"""

from __future__ import annotations

import math
import sys

import torch

from splatslam_tpu_torch.models import dpt as dpt_mod

from ..check import _rel, lower_precision
from ..probes import clone
from ..reference import dpt as ref_dpt

NUMBERS = ("prior_gap",)


def arm(slot, p):
    def wrap(orig):
        def f(model, x):
            out = orig(model, x)
            if not slot.full:
                slot.put(dict(x=clone(x), out=clone(out),
                              weights=clone(model.state_dict())))
            return out
        return f
    p.put(dpt_mod.DPTDepthModel, "forward", wrap)


def run(ctx, cap, dtype):
    """The reference's pass on the captured input and weights, in
    `dtype` on the run's device."""
    sd = {k: v.to(ctx.device, dtype) for k, v in cap["weights"].items()}
    return ref_dpt.forward(sd, cap["x"].to(ctx.device, dtype))


@torch.no_grad()
def reference(ctx, cap):
    """The reference's output, or None where the capture is not the
    published network."""
    off = ref_dpt.departures(cap["weights"], cap["x"].shape)
    if off:
        print(f"prior: not the published network: {off[:4]}",
              file=sys.stderr)
        return None
    return run(ctx, cap, torch.float64)


@torch.no_grad()
def gaps(cap, ref):
    return {"prior_gap": math.inf if ref is None else _rel(cap["out"], ref)}


@torch.no_grad()
def control(ctx, cap, ref):
    if ref is None:
        return {"prior_gap": math.inf}
    with lower_precision():
        r = run(ctx, cap, torch.float32)
    return {"prior_gap": _rel(r, ref)}
