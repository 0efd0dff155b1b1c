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
SOURCES = (_SRC,)        # every CUDA source the port builds
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches, incremented where each wrapper launches its kernel
launches = {"composite_fwd": 0, "composite_bwd": 0}

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


def library_path(src: Path = _SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_command(src: Path = _SRC):
    """(nvcc argv, target path) for one kernel source; the caller may run
    several such commands at once (chip_smoke.py does)."""
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


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.composite_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.composite_fwd.restype = i
        lib.composite_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.composite_bwd.restype = i
        _lib = lib
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
    err = lib.composite_fwd(
        packets.data_ptr(), tile_ids.data_ptr(), counts.data_ptr(),
        out.data_ptr(), ntouch.data_ptr(), B, N, T, K, int(ntx),
        int(bool(want_touched)),
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
    err = lib.composite_bwd(
        packets.data_ptr(), tile_ids.data_ptr(), counts.data_ptr(),
        gout.data_ptr(), fwdout.data_ptr(), grad.data_ptr(), B, N, T, K,
        int(ntx), torch.cuda.current_stream(packets.device).cuda_stream)
    _raise_on(err, "composite_bwd")
    launches["composite_bwd"] += 1
    return grad
