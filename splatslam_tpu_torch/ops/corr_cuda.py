"""Wrapper of the hand-written local correlation kernel (csrc/corr.cu).

    alt_corr  <- ops/corr.alt_corr

It replaces no TPU kernel: it was added because the plain version builds
the whole level-0 correlation volume to read a 7×7 window of it, in chunks
of a few edges, each chunk a hundred launches. The kernel correlates each
warp's 16 source pixels with the target positions their windows cover, on
the tensor cores (bf16 products, float32 sums), and holds no volume.
Built and bound as csrc/composite.cu is (ops/raster_cuda: nvcc for sm_90a
into build/kernels/ at first use, ctypes, PyTorch's current stream).

The caller (tracking/factor_graph.update_operator) dispatches by where its
inputs are: CUDA tensors take this wrapper, CPU tensors the plain version.
The kernel has no backward, so this wrapper raises on a call that needs a
gradient (the self-trainer differentiates ops/corr.alt_corr, which it calls
itself). tracking/factor_graph.edge_frames hands the pyramid channels-last
on the card, the layout the kernel reads; other layouts are copied here.
"""

from __future__ import annotations

import ctypes

import torch

from . import raster_cuda

# kernel launches, incremented where the wrapper launches the kernel
launches = {"alt_corr": 0}

LEVELS = 4
RADIUS = 3
CHANNELS = 128
WINDOW = (2 * RADIUS + 1) ** 2          # 49 samples a level
TAPS = (2 * RADIUS + 2) ** 2            # the 8 × 8 integer taps under them

# Bound reckoning (kernel_bounds): operations a (edge, source pixel,
# level) needs, counted from the plain version's arithmetic for what the
# output needs: the 64 taps' dot products over 128 channels (a multiply
# and an add each), which the kernel runs on the tensor cores, and on the
# FP32 units the 28 hat weights (two subtractions, |.|, 1 − and the max: 5
# each) and the 49 outputs' combine (6 multiplies, 3 adds each).
DOT_OPS = TAPS * CHANNELS * 2
COMBINE_OPS = 4 * (2 * RADIUS + 1) * 5 + WINDOW * 9


def level_sizes(h, w):
    """(h_l, w_l) of the four pyramid levels: 2×2 pooling with floor."""
    sizes = [(h, w)]
    for _ in range(LEVELS - 1):
        h, w = h // 2, w // 2
        sizes.append((h, w))
    return sizes


def kernel_bounds(E, P, h, w, out_bytes=2):
    """Least milliseconds an H100 could take for alt_corr on E edges among
    P frames of h × w (level 0): (ms, "bytes" | "tensor operations" |
    "FP32 operations"). The largest of the bytes the function must move
    (every pyramid level of the P frames read once as bf16, the edges' rows
    and coordinates read once, the (E, 196, h, w) output written once in
    `out_bytes` a value) over the card's memory rate, its dot products over
    the dense bf16 peak of the tensor cores and its weights and combine
    over the FP32 peak outside them: each unit does its share at least."""
    pyr = sum(hl * wl for hl, wl in level_sizes(h, w))
    nbytes = (P * CHANNELS * pyr * 2 + E * 16 + E * h * w * 2 * 4
              + E * LEVELS * WINDOW * h * w * out_bytes)
    n = E * h * w * LEVELS
    ms = {"bytes": nbytes / raster_cuda.HBM_BYTES_PER_S * 1e3,
          "tensor operations":
              n * DOT_OPS / raster_cuda.BF16_TENSOR_OPS_PER_S * 1e3,
          "FP32 operations":
              n * COMBINE_OPS / raster_cuda.FP32_OPS_PER_S * 1e3}
    by = max(ms, key=ms.get)
    return ms[by], by


_lib = None


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def bind(path):
    """The C entry point of a built library, with its argument types."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.corr_alt.argtypes = [p] * 9 + [i] * 4 + [p, p]
    lib.corr_alt.restype = i
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(raster_cuda.build(raster_cuda.CORR_SRC))
    return _lib


def _aligned(x, memory_format=torch.contiguous_format):
    """x laid out densely in `memory_format` at a 16-byte aligned address
    (the kernel reads 16 bytes at a time)."""
    x = x.contiguous(memory_format=memory_format)
    if x.data_ptr() % 16:
        x = x.clone(memory_format=memory_format)
    return x


def _needs_grad(coords, fmap_pyr):
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (coords, *fmap_pyr))


def takes(coords):
    """Whether alt_corr's kernel takes these targets: CUDA tensors."""
    return coords.is_cuda


def alt_corr(fmap_pyr, ii, jj, coords, out_dtype=torch.float32):
    """ops/corr.alt_corr of every edge at once on the card: fmap_pyr the
    four levels of build_fmap_pyramid (P, 128, h/2ˡ, w/2ˡ) in bf16, as
    the video's features give them; ii/jj (N,) rows of it; coords (N, h,
    w, 2) float32 level-0
    targets → (N, 196, h, w) in `out_dtype` (float32 or bf16, rounded to
    nearest even), radius 3."""
    if _needs_grad(coords, fmap_pyr):
        raise RuntimeError("alt_corr: the kernel has no gradient; a call "
                           "that needs one calls ops/corr.alt_corr")
    dev = coords.device
    if not takes(coords):
        raise ValueError(f"alt_corr: want cuda tensors, got {dev}")
    if len(fmap_pyr) != LEVELS:
        raise ValueError(f"alt_corr: want {LEVELS} levels, got "
                         f"{len(fmap_pyr)}")
    N, h, w, _ = coords.shape
    if tuple(coords.shape) != (N, h, w, 2) or coords.dtype != torch.float32:
        raise ValueError(f"coords: want float32 ({N}, {h}, {w}, 2), got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"alt_corr: out_dtype {out_dtype}, want bf16 or "
                         "float32")
    P = fmap_pyr[0].shape[0]
    levels = []
    for lvl, (f, (hl, wl)) in enumerate(zip(fmap_pyr, level_sizes(h, w))):
        if tuple(f.shape) != (P, CHANNELS, hl, wl) \
                or f.dtype != torch.bfloat16 or f.device != dev:
            raise ValueError(f"level {lvl}: want {dev} bf16 "
                             f"{(P, CHANNELS, hl, wl)}, got {f.device} "
                             f"{f.dtype} {tuple(f.shape)}")
        levels.append(_aligned(f, torch.channels_last))
    for name, x in (("ii", ii), ("jj", jj)):
        if x.dtype != torch.long or tuple(x.shape) != (N,) \
                or x.device != dev:
            raise ValueError(f"{name}: want {dev} int64 ({N},), got "
                             f"{x.device} {x.dtype} {tuple(x.shape)}")
    ii, jj, coords = ii.contiguous(), jj.contiguous(), _aligned(coords)
    out = torch.empty((N, LEVELS * WINDOW, h, w), dtype=out_dtype,
                      device=dev)
    sizes = level_sizes(h, w)
    lh = (ctypes.c_int * LEVELS)(*[s[0] for s in sizes])
    lw = (ctypes.c_int * LEVELS)(*[s[1] for s in sizes])
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.corr_alt(
            *[f.data_ptr() for f in levels], lh, lw, ii.data_ptr(),
            jj.data_ptr(), coords.data_ptr(), N, h, w,
            int(out_dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raster_cuda._raise_on(err, "alt_corr")
    launches["alt_corr"] += 1
    return out
