"""The tracker's FLOP terms, under the kind "tracking": the admission
scan, the encoders, the update operator, the oracle's targets, the
bundle adjustments of both DSPO stages and the frame distances."""

from splatslam_tpu_torch.ops import ba as ba_ops
from splatslam_tpu_torch.tracking import depth_video as dv_mod
from splatslam_tpu_torch.tracking import factor_graph as fg_mod
from splatslam_tpu_torch.tracking import motion_filter as mf_mod

from .. import flops as F
from . import Term


def scan(orig, c, add):
    def f(model, images_u8, *a, **kw):
        add(F.admission(images_u8.shape[0], c.hw, c.h8w8))
        return orig(model, images_u8, *a, **kw)
    return f


def encoder(orig, c, add):
    def f(model, image, *a, **kw):
        add(F.encoder(c.hw))
        return orig(model, image, *a, **kw)
    return f


def update(orig, c, add):
    def f(model, poses, disps, intrinsics, fmaps, inps, net, target, ii, jj,
          *a, **kw):
        add(F.update_operator(ii.shape[0], c.h8w8))
        return orig(model, poses, disps, intrinsics, fmaps, inps, net,
                    target, ii, jj, *a, **kw)
    return f


def oracle(orig, c, add):
    def f(graph):
        add(F.oracle_targets(len(graph.ii), c.h8w8))
        return orig(graph)
    return f


def dba(orig, c, add):
    def f(poses, disps, intrinsics, target, weight, eta, sensor_disps, edges,
          iters=2, *a, **kw):
        add(F.ba_iterations(iters, edges.ii.shape[0], c.h8w8))
        return orig(poses, disps, intrinsics, target, weight, eta,
                    sensor_disps, edges, iters, *a, **kw)
    return f


def scale_shift(orig, c, add):
    def f(*a, **kw):
        edges = a[10] if len(a) > 10 else kw["edges"]
        add(F.ba_iterations(1, edges.ii.shape[0], c.h8w8))
        return orig(*a, **kw)
    return f


def distance(orig, c, add):
    def f(poses, disps, intrinsics, ii, jj, *a, **kw):
        add(F.frame_distance(ii.shape[0], c.h8w8))
        return orig(poses, disps, intrinsics, ii, jj, *a, **kw)
    return f


TERMS = [
    Term(mf_mod, "admission_scan", "tracking", scan),
    Term(mf_mod, "encode_features", "tracking", encoder),
    Term(mf_mod, "encode_context", "tracking", encoder),
    Term(fg_mod, "update_operator", "tracking", update),
    Term(fg_mod.FactorGraph, "_oracle_targets", "tracking", oracle),
    Term(ba_ops, "dba", "tracking", dba),
    Term(ba_ops, "_scale_shift_iteration", "tracking", scale_shift),
    Term(dv_mod, "frame_distance", "tracking", distance),
    Term(fg_mod, "frame_distance", "tracking", distance),
]
