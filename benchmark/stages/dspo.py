"""A stage-2 DSPO iteration (`ops/ba._scale_shift_iteration`): disparities
and each frame's mono-prior scale and shift, poses frozen. The one taken
is the first iteration after arming that starts from a fresh fit of (w, q)
(`ops/ba.align_scale_and_shift`, which each stage-2 round calls before its
iterations): a round's later iterations move the state by a fraction of
the first's, and their relative gap reads the float32 rounding of the
outputs more than the arithmetic (several times the first's).

  dspo_gap    the iteration worked out again in float64: the change it
              makes to the disparities of the frames it touches (the edge
              set's depth frames, relative L2), and to those frames' scale
              and shift (w, q), relative L2 over both; the worse of the
              two. The change, not the raw values, for dba_gap's reason:
              an iteration moves a disparity by a small share of it, which
              the values' own float32 rounding would hide.

Control: the iteration in float32 with TF32 and in bfloat16 storage, as
the dba stage's control.
"""

from __future__ import annotations

import torch

from splatslam_tpu_torch.ops import ba as ba_ops

from ..check import _bf16, lower_precision
from ..probes import clone
from ..reference import ba as ref_ba
from ..reference import dspo as ref_dspo

NUMBERS = ("dspo_gap",)


def arm(slot, p):
    fresh = [False]     # (w, q) fit since the last iteration

    def fit(orig):
        def f(*a, **kw):
            fresh[0] = True
            return orig(*a, **kw)
        return f

    def wrap(orig):
        def f(poses, disps, intrinsics, target, weight, eta, mono_disps,
              scales, shifts, valid_depth_mask, edges, lm=1e-4, ep=0.1,
              alpha=0.01, kx_mask=None):
            args = (poses, disps, intrinsics, target, weight, eta,
                    mono_disps, scales, shifts, valid_depth_mask, edges, lm,
                    ep, alpha)
            first, fresh[0] = fresh[0], False
            if slot.full or not first:
                return orig(*args, kx_mask=kx_mask)
            cap = dict(poses=clone(poses), disps=clone(disps),
                       intrinsics=clone(intrinsics), target=clone(target),
                       weight=clone(weight), eta=clone(eta),
                       mono=clone(mono_disps), scales=clone(scales),
                       shifts=clone(shifts), valid=clone(valid_depth_mask),
                       ii=clone(edges.ii), jj=clone(edges.jj), t0=edges.t0,
                       t1=edges.t1, lm=lm, ep=ep, alpha=alpha,
                       kx_mask=clone(kx_mask))
            out = orig(*args, kx_mask=kx_mask)
            cap["out"] = clone(out)
            slot.put(cap)
            return out
        return f
    p.put(ba_ops, "align_scale_and_shift", fit)
    p.put(ba_ops, "_scale_shift_iteration", wrap)


def iteration(cap, dtype):
    """The iteration in `dtype`, its result in `dtype`."""
    edges = ref_ba.make_edges(cap["ii"], cap["jj"], cap["t0"], cap["t1"],
                              cap["ii"].device)
    c = lambda k: cap[k].to(dtype)
    return ref_dspo.scale_shift_iteration(
        c("poses"), c("disps"), c("intrinsics"), c("target"), c("weight"),
        c("eta"), c("mono"), c("scales"), c("shifts"), cap["valid"], edges,
        cap["lm"], cap["ep"], cap["alpha"], cap["kx_mask"])


def dspo_gap(cap, out, ref):
    """`out` and `ref` (disps, scales, shifts); their changes from the
    captured inputs taken in float64."""
    kx = ref_ba.make_edges(cap["ii"], cap["jj"], cap["t0"], cap["t1"],
                           cap["ii"].device).kx
    d = lambda o: o[0][kx].double() - cap["disps"][kx].double()
    wq = lambda o: torch.stack(
        [o[1][kx].double() - cap["scales"][kx].double(),
         o[2][kx].double() - cap["shifts"][kx].double()], -1)
    return max(_rel64(d(out), d(ref)), _rel64(wq(out), wq(ref)))


def _rel64(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-300))


@torch.no_grad()
def reference(ctx, cap):
    return iteration(cap, torch.float64)


@torch.no_grad()
def gaps(cap, ref):
    return {"dspo_gap": dspo_gap(cap, cap["out"], ref)}


@torch.no_grad()
def control(ctx, cap, ref):
    with lower_precision():
        r = _bf16(iteration(_bf16(cap), torch.float32))
    return {"dspo_gap": dspo_gap(cap, r, ref)}
