"""Wrappers of the hand-written 3DGS compositing kernels (counterpart of
splatslam_tpu/ops/raster_pallas.py).

    B1 composite_fwd  <- raster_pallas.composite_fwd_pallas
    B2 composite_bwd  <- raster_pallas.composite_bwd_pallas

The CUDA C++ sources are csrc/composite.cu, compiled with nvcc for
sm_90a into a shared library with a plain C interface at first use
(build/kernels/ at the repository root) and called through ctypes on
PyTorch's current stream.

Dispatch is by the device of the tensors only: CPU tensors go to the
plain PyTorch versions in ops/rasterizer.py (composite_fwd_torch /
composite_bwd_torch); CUDA tensors launch the kernel or raise.

Wrapper-level signature (shared with the plain versions):
    packets (B, N, 10) f32   [mean_x, mean_y, conic a, b, c, r, g, b,
                              opacity, depth] per camera and Gaussian
    tile_ids (B, T, K) i32   depth-sorted contributor ids, -1 padding
    counts (B, T) i32        contributors per tile (may exceed K)
    out / fwdout / gout (B, T, 5, 256) f32   rows [r, g, b, depth, alpha]
                              per 16×16 tile pixel (color pre-background)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "composite.cu"
DSPO_SRC = _SRC.with_name("dspo.cu")      # ops/dspo_cuda.py
CORR_SRC = _SRC.with_name("corr.cu")      # ops/corr_cuda.py
SOURCES = (_SRC, DSPO_SRC, CORR_SRC)  # every CUDA source the port builds
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches, incremented where each wrapper launches its kernel
launches = {"composite_fwd": 0, "composite_bwd": 0}

# Bound reckoning (kernel_bounds). A (pixel, contributor) pair that carries
# a weight costs, in FP32 operations counted from the arithmetic the plain
# versions define (exp as one): B1 evaluates the Gaussian (11), gates and
# clamps alpha (5), updates transmittance and the weight (4) and accumulates
# four channels (8); B2 repeats the evaluation and gating (20), forms s and
# the suffix (9), dL/dalpha (6), the chain through the clamp (3), the ten
# field products (20) and its share of the sum over the tile's pixels (2).
# A pair without a weight is an exact zero of both functions, known after
# the evaluation (11) and one comparison of the power with the opacity's
# threshold. The counts belong to the function, not to a kernel design.
FWD_OPS_PER_PAIR = 28
BWD_OPS_PER_PAIR = 60
DEAD_OPS_PER_PAIR = 12
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_OPS_PER_S = 67e12          # H100 SXM FP32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
SM_COUNT = 132                  # H100 SXM

# Issues on an SM's load/store-and-shuffle pipe (one warp-wide shared load,
# shared store, shuffle or atomic per clock) per contributor and warp, read
# from csrc/composite.cu: 3 broadcast 16-byte shared loads and one vote; B1
# adds one warp sum for n_touched, B2 the 12 shuffles of reduce10 and one
# atomic instruction. A warp covers 32 · P pairs per contributor, so per 32
# pairs that is 5/P and 17/P. The design before this one (one thread per
# pixel) spent 12 (B1) and 71 (B2) per 32 pairs.
LSU_ISSUES_PER_CONTRIBUTOR = {"composite_fwd": 5, "composite_bwd": 17}

# pixels per thread each kernel is built for (csrc/composite.cu)
PIXELS_PER_THREAD = {"composite_fwd": (2, 4), "composite_bwd": (4, 8)}

_lib = None


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def _nvcc():
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the compositing kernels")
    return exe


def kernel_bounds(B, N, T, K, pairs, live_pairs=None):
    """Least milliseconds an H100 could take for B1 and B2 on one input:
    {"composite_fwd": (ms, "bytes" | "operations"), "composite_bwd": ...}.

    The larger of the bytes each function must move (every input read
    once, every output written once) over the card's memory rate and its
    FP32 operations over the card's peak rate outside the tensor cores.
    `pairs` is the input's (pixel, contributor) pair count,
    256 · Σ min(count, K) — what this input needs, not B·T·K·256 — and
    `live_pairs` how many of them carry a weight > 0 (the sum of B1's
    n_touched): those cost the full 28 (B1) or 60 (B2) operations, the
    others 12. Without `live_pairs` every pair is charged in full."""
    live = pairs if live_pairs is None else live_pairs
    dead = pairs - live
    n_in = 4 * (B * N * 10 + B * T * K + B * T)
    n_out = 4 * B * T * 5 * 256
    fwd_bytes = n_in + n_out + 4 * B * N
    bwd_bytes = n_in + 2 * n_out + 4 * B * N * 10

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    dead_ops = dead * DEAD_OPS_PER_PAIR
    return {
        "composite_fwd": bound(fwd_bytes, live * FWD_OPS_PER_PAIR + dead_ops),
        "composite_bwd": bound(bwd_bytes, live * BWD_OPS_PER_PAIR + dead_ops)}


def pixels_per_thread(name, n_tiles):
    """How many of a tile's 256 pixels one thread of kernel `name`
    composites on a grid of `n_tiles` = B · T tiles: 8 is one warp per
    tile, 4 and 2 split a tile over 2 and 4 warps. Fewer pixels per
    thread cost more staging, votes and atomics per pixel but fill the
    card when the tiles are few, and cull finer. B1 is built for 2 and 4,
    B2 for 4 and 8 (PIXELS_PER_THREAD); the thresholds are where the times
    of `chip_smoke.py --kernels-only --sweep-pixels-per-thread` cross on
    an H100 at 800 tiles per camera."""
    if name == "composite_fwd":
        return 2 if n_tiles < 1200 else 4
    return 4 if n_tiles < 6000 else 8


def lsu_issues_per_32_pairs(name, n_tiles):
    return LSU_ISSUES_PER_CONTRIBUTOR[name] / pixels_per_thread(name, n_tiles)


def lsu_pipe_ms(name, pairs, sm_clock_hz, n_tiles):
    """Milliseconds the load/store-and-shuffle pipe alone needs for kernel
    `name` on `pairs` pairs of a grid of `n_tiles` tiles at the given SM
    clock: the wall the first design stood at."""
    return (pairs / 32 * lsu_issues_per_32_pairs(name, n_tiles)
            / (SM_COUNT * sm_clock_hz) * 1e3)


def library_path(src: Path = _SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_command(src: Path = _SRC):
    """(nvcc argv, temporary output, target path) for one kernel source;
    the caller may run several such commands at once (chip_smoke.py
    does)."""
    target = library_path(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    return [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)], tmp, target


def build(src: Path = _SRC) -> Path:
    """Compile `src` unless its library (keyed by source + flags) exists."""
    target = library_path(src)
    if target.exists():
        return target
    cmd, tmp, target = build_command(src)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    os.replace(tmp, target)
    return target


def bind(path):
    """The C entry points of a built library, with their argument types."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.composite_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.composite_fwd.restype = i
    lib.composite_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.composite_bwd.restype = i
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"{name}: want contiguous cuda {dtype} {tuple(shape)}"
                         f", got {x.device} {x.dtype} {tuple(x.shape)}"
                         f" contiguous={x.is_contiguous()}")


def _check_all(packets, tile_ids, counts):
    B, N, _ = packets.shape
    _, T, K = tile_ids.shape
    _check("packets", packets, torch.float32, (B, N, 10))
    _check("tile_ids", tile_ids, torch.int32, (B, T, K))
    _check("counts", counts, torch.int32, (B, T))
    dev = packets.device
    if tile_ids.device != dev or counts.device != dev:
        raise ValueError("packets, tile_ids and counts must share a device")
    if packets.data_ptr() % 8:
        raise ValueError("packets: the kernels gather rows with 8-byte "
                         "copies and need an 8-byte aligned tensor")
    return B, N, T, K


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def composite_fwd(packets, tile_ids, counts, ntx: int,
                  want_touched: bool = True):
    """B1: returns (out (B,T,5,256) f32, n_touched (B,N) i32 — all zero
    when want_touched is False)."""
    if packets.device.type == "cpu":
        from .rasterizer import composite_fwd_torch
        return composite_fwd_torch(packets, tile_ids, counts, ntx,
                                   want_touched)
    B, N, T, K = _check_all(packets, tile_ids, counts)
    out = torch.empty((B, T, 5, 256), dtype=torch.float32,
                      device=packets.device)
    ntouch = torch.zeros((B, N), dtype=torch.int32, device=packets.device)
    lib = _load()
    # the runtime launches on the calling thread's current device
    with torch.cuda.device(packets.device):
        err = lib.composite_fwd(
            packets.data_ptr(), tile_ids.data_ptr(), counts.data_ptr(),
            out.data_ptr(), ntouch.data_ptr(), B, N, T, K, int(ntx),
            int(bool(want_touched)), pixels_per_thread("composite_fwd", B * T),
            torch.cuda.current_stream(packets.device).cuda_stream)
    _raise_on(err, "composite_fwd")
    launches["composite_fwd"] += 1
    return out, ntouch


def composite_bwd(packets, tile_ids, counts, ntx: int, gout, fwdout):
    """B2: per-camera per-Gaussian packet gradients (B, N, 10) f32 from
    the output cotangents `gout` and the forward's output `fwdout`."""
    if packets.device.type == "cpu":
        from .rasterizer import composite_bwd_torch
        return composite_bwd_torch(packets, tile_ids, counts, ntx, gout,
                                   fwdout)
    B, N, T, K = _check_all(packets, tile_ids, counts)
    _check("gout", gout, torch.float32, (B, T, 5, 256))
    _check("fwdout", fwdout, torch.float32, (B, T, 5, 256))
    grad = torch.zeros((B, N, 10), dtype=torch.float32,
                       device=packets.device)
    lib = _load()
    with torch.cuda.device(packets.device):
        err = lib.composite_bwd(
            packets.data_ptr(), tile_ids.data_ptr(), counts.data_ptr(),
            gout.data_ptr(), fwdout.data_ptr(), grad.data_ptr(), B, N, T, K,
            int(ntx), pixels_per_thread("composite_bwd", B * T),
            torch.cuda.current_stream(packets.device).cuda_stream)
    _raise_on(err, "composite_bwd")
    launches["composite_bwd"] += 1
    return grad
