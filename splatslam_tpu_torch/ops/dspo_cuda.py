"""Wrappers of the hand-written DSPO stage-2 kernels (csrc/dspo.cu).

    scale_shift_iteration  <- ops/ba._scale_shift_iteration_torch
    depth_filter           <- tracking/depth_video.depth_filter_torch

Neither replaces a TPU kernel: both were added because their plain
versions are chains of hundreds of small operations whose launches the
host could not issue as fast as the card ran them. Built and bound as
csrc/composite.cu is (ops/raster_cuda: nvcc for sm_90a into build/kernels/
at first use, ctypes, PyTorch's current stream).

The callers dispatch by the device of the tensors only: CPU tensors take
the plain versions; these wrappers take CUDA tensors and launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import raster_cuda

# kernel launches, incremented where each wrapper launches its kernel
launches = {"scale_shift_iteration": 0, "depth_filter": 0}

# Bound reckoning (kernel_bounds): FP32 operations counted from the plain
# versions' arithmetic for what the outputs need (the pose Jacobians that
# the plain iteration forms and drops are not counted). An iteration spends
# 81 a (edge, pixel) pair: back-projection 4, the point's rotation and
# translation 36, projection 8, validity 2, Jz 14, the residual, weight and
# the two sums 17; and 50 a depth-frame pixel: the prior's residual and
# Jacobians, the ten sums, Q, w, dz and its tests. The filter spends 74 a
# (frame, pixel, neighbour): rotation and translation 36, projection and
# inverse depths 13, floor and the bounds 6, the four taps 16, their or 3.
ITER_OPS_PER_EDGE_PIXEL = 81
ITER_OPS_PER_FRAME_PIXEL = 50
FILTER_OPS_PER_NEIGHBOUR_PIXEL = 74


def kernel_bounds(E, M, B, hw, n_filter=0, filter_rows=0):
    """Least milliseconds an H100 could take for an iteration on E edges,
    M depth frames and a buffer of B frames of hw pixels, and for the
    filter of n_filter frames that reads filter_rows distinct disparity
    rows: {"scale_shift_iteration": (ms, "bytes" | "operations"),
    "depth_filter": ...}. The larger of the bytes each function must move
    (every input read once, every output written once: the iteration's
    outputs are whole copies of the buffer's disparities, scales and
    shifts) over the card's memory rate and its operations over the FP32
    peak outside the tensor cores."""
    it_bytes = E * hw * 16 + B * hw * 8 + M * hw * 9 + B * 44
    it_ops = hw * (E * ITER_OPS_PER_EDGE_PIXEL
                   + M * ITER_OPS_PER_FRAME_PIXEL)
    f_bytes = filter_rows * hw * 4 + n_filter * hw * 4
    f_ops = n_filter * hw * 6 * FILTER_OPS_PER_NEIGHBOUR_PIXEL

    def bound(nbytes, ops):
        tb = nbytes / raster_cuda.HBM_BYTES_PER_S * 1e3
        to = ops / raster_cuda.FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    return {"scale_shift_iteration": bound(it_bytes, it_ops),
            "depth_filter": bound(f_bytes, f_ops)}


_lib = None


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def bind(path):
    """The C entry points of a built library, with their argument types."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dspo_scale_shift.argtypes = [p] * 15 + [f, f, f, i, i, i] + [p] * 5
    lib.dspo_scale_shift.restype = i
    lib.dspo_depth_filter.argtypes = [p] * 5 + [i, i, i, i, p, p]
    lib.dspo_depth_filter.restype = i
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(raster_cuda.build(raster_cuda.DSPO_SRC))
    return _lib


def _take(name, x, dtype, shape, device):
    """x as a contiguous tensor the kernel reads, or a ValueError."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device:
        raise ValueError(f"{name}: want {device} {dtype} {tuple(shape)}, got "
                         f"{x.device} {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def scale_shift_iteration(poses, disps, intrinsics, target, weight, eta,
                          mono_disps, scales, shifts, valid_depth_mask,
                          edges, lm, ep, alpha, kx_mask=None):
    """One stage-2 iteration on the card; returns new (disps, scales,
    shifts), out of place, as ops/ba._scale_shift_iteration_torch."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (poses, disps, intrinsics, target,
                                      weight, eta, mono_disps, scales,
                                      shifts)):
        raise RuntimeError("scale_shift_iteration: the kernel has no "
                           "gradient, and no path differentiates stage 2")
    dev = disps.device
    if dev.type != "cuda":
        raise ValueError(f"scale_shift_iteration: want cuda tensors, got "
                         f"{dev}")
    B, h, w = disps.shape
    E, M = edges.ii.shape[0], edges.M
    f32 = torch.float32
    poses = _take("poses", poses, f32, (B, 7), dev)
    disps = _take("disps", disps, f32, (B, h, w), dev)
    intrinsics = _take("intrinsics", intrinsics, f32, (4,), dev)
    target = _take("target", target, f32, (E, h, w, 2), dev)
    weight = _take("weight", weight, f32, (E, h, w, 2), dev)
    eta = _take("eta", eta, f32, (M, h, w), dev)
    mono_disps = _take("mono_disps", mono_disps, f32, (B, h, w), dev)
    scales = _take("scales", scales, f32, (B,), dev)
    shifts = _take("shifts", shifts, f32, (B,), dev)
    valid = _take("valid_depth_mask", valid_depth_mask, torch.bool,
                  (B, h, w), dev)
    jj = _take("jj", edges.jj, torch.long, (E,), dev)
    kx = _take("kx", edges.kx, torch.long, (M,), dev)
    if kx_mask is not None:
        kx_mask = _take("kx_mask", kx_mask, torch.bool, (M,), dev)
    order, offsets = edges.by_frame()
    disps_out, scales_out, shifts_out = (disps.clone(), scales.clone(),
                                         shifts.clone())
    scratch = torch.empty((M, h * w, 4), dtype=f32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.dspo_scale_shift(
            poses.data_ptr(), disps.data_ptr(), intrinsics.data_ptr(),
            target.data_ptr(), weight.data_ptr(), eta.data_ptr(),
            mono_disps.data_ptr(), scales.data_ptr(), shifts.data_ptr(),
            valid.data_ptr(), jj.data_ptr(), kx.data_ptr(),
            order.data_ptr(), offsets.data_ptr(),
            None if kx_mask is None else kx_mask.data_ptr(), float(lm),
            float(ep), float(alpha), M, h, w, disps_out.data_ptr(),
            scales_out.data_ptr(), shifts_out.data_ptr(),
            scratch.data_ptr(), _stream(dev))
    raster_cuda._raise_on(err, "scale_shift_iteration")
    launches["scale_shift_iteration"] += 1
    return disps_out, scales_out, shifts_out


def depth_filter(poses, disps, intrinsics, inds, thresh):
    """The multiview consistency count on the card: (len(inds), h, w)
    float, as tracking/depth_video.depth_filter_torch."""
    dev = disps.device
    if dev.type != "cuda":
        raise ValueError(f"depth_filter: want cuda tensors, got {dev}")
    num, h, w = disps.shape
    n = inds.shape[0]
    f32 = torch.float32
    poses = _take("poses", poses, f32, (num, 7), dev)
    disps = _take("disps", disps, f32, (num, h, w), dev)
    intrinsics = _take("intrinsics", intrinsics, f32, (4,), dev)
    inds = _take("inds", inds, torch.long, (n,), dev)
    thresh = _take("thresh", thresh, f32, (n,), dev)
    counts = torch.empty((n, h, w), dtype=f32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.dspo_depth_filter(
            poses.data_ptr(), disps.data_ptr(), intrinsics.data_ptr(),
            inds.data_ptr(), thresh.data_ptr(), n, num, h, w,
            counts.data_ptr(), _stream(dev))
    raster_cuda._raise_on(err, "depth_filter")
    launches["depth_filter"] += 1
    return counts
