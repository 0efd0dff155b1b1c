"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py      # kernels + the main path (one card)

Phases, each unguarded (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA source under splatslam_tpu_torch/csrc/ (one nvcc
     per source, all started together);
  3. kernel phase: B1/B2 (3DGS tile compositor forward/backward) on a real
     input at replica_scale shapes (10 cameras, 320x640, K=256, capacity
     131072), binned from a seeded Gaussian cloud by the port's bin_batch,
     held against their plain PyTorch versions on the card, then timed
     with CUDA events (warm-up, median of 10);
  4. main path: configs/Synthetic/replica_scale.yaml through the port's
     SLAM at full width and full depth, with every kernel launch count reset just before and read just after;
  5. a torch.profiler window over a few mapping iterations of the final
     keyframe window (device time by kernel, device busy share);
  6. the kernels JSON line, then the device JSON line last.

Exits non-zero without printing a result when no CUDA device is present,
or when the port's package is not beside this script.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (pixel, contributor) pair cost in FP32 operations, counted from the kernel
# source (exp counted as one): B1 evaluates the Gaussian (11), gates and
# clamps alpha (5), updates transmittance and the weight (4) and accumulates
# four channels (8); B2 repeats the evaluation and gating (20), forms s and
# the suffix (9), dL/dalpha (6), the chain through the clamp (3) and the ten
# field products (20), and reduces them over the warp (10 fields x 5 steps /
# 32 lanes ~ 2).
FWD_OPS_PER_PAIR = 28
BWD_OPS_PER_PAIR = 60
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_OPS_PER_S = 67e12          # H100 SXM FP32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def build_kernels():
    """Compile every csrc/*.cu into its .so, one nvcc process each, all at
    once. Returns the wall seconds."""
    from splatslam_tpu_torch.ops import raster_cuda
    t0 = time.perf_counter()
    procs = []
    for src in raster_cuda.SOURCES:
        if raster_cuda.library_path(src).exists():
            continue
        cmd, tmp, target = raster_cuda.build_command(src)
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True),
                      tmp, target, src))
    for p, tmp, target, src in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err}")
        os.replace(tmp, target)
    return time.perf_counter() - t0


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of `fn` over `reps` CUDA-event-timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_input(dev, seed=0, B=10, H=320, W=640, N=131072, K=256):
    """A seeded Gaussian cloud in front of B cameras, projected and binned
    by the port's own functions: (packets, tile_ids, counts, ntx)."""
    import torch
    from splatslam_tpu_torch.ops import lie, rasterizer as R
    g = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    depth = 1.0 + 4.0 * u(N)
    xy = (u(N, 2) * 2 - 1) * torch.tensor([1.1, 0.55]) * depth[:, None]
    means = torch.cat([xy, depth[:, None]], 1)
    scales = torch.exp(math.log(0.004) + u(N, 3) * math.log(12.0))
    rots = torch.randn(N, 4, generator=g)
    opac = 0.05 + 0.94 * u(N)
    colors = u(N, 3)
    taus = torch.cat([(u(B, 3) - 0.5) * 0.2, (u(B, 3) - 0.5) * 0.1], 1)
    w2cs = torch.eye(4).expand(B, 4, 4).contiguous()
    intr = torch.tensor([300.0, 300.0, (W - 1) / 2, (H - 1) / 2])
    alive = torch.ones(N, dtype=torch.bool)
    t = [x.to(dev) for x in (means, scales, rots, opac, colors, alive, w2cs,
                             taus, intr)]
    means, scales, rots, opac, colors, alive, w2cs, taus, intr = t
    tile_ids, counts = R.bin_batch(means, scales, rots, opac, alive, w2cs,
                                   taus, intr, H=H, W=W, K=K)
    w2c_t = lie.to_matrix(lie.exp(taus)) @ w2cs
    m2d, dz, conic, _, vis = R.project_gaussians(means, scales, rots, w2c_t,
                                                 intr, H, W)
    packets = R.make_packets(m2d, conic, colors[None].expand(B, N, 3), opac,
                             dz)
    return packets, tile_ids, counts, (W + R.TILE - 1) // R.TILE


def kernel_phase(dev):
    import torch
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R
    packets, tile_ids, counts, ntx = kernel_input(dev)
    B, N, _ = packets.shape
    _, T, K = tile_ids.shape
    pairs = int(torch.clamp(counts, max=K).sum()) * R.NPIX
    log(f"kernel input: B={B} T={T} K={K} N={N} mean count "
        f"{counts.float().mean().item():.1f} overflow tiles "
        f"{int((counts > K).sum())} pixel-contributor pairs {pairs}")

    out_k, nt_k = raster_cuda.composite_fwd(packets, tile_ids, counts, ntx)
    out_p, nt_p = R.composite_fwd_torch(packets, tile_ids, counts, ntx)
    torch.cuda.synchronize()
    err_cd = (out_k[:, :, :4] - out_p[:, :, :4]).abs().max().item()
    err_a = (out_k[:, :, 4] - out_p[:, :, 4]).abs().max().item()
    nt_eq = bool(torch.equal(nt_k, nt_p))
    log(f"B1 vs plain: color/depth max|err| {err_cd:.3e} (tol 1e-5), alpha "
        f"max|err| {err_a:.3e} (tol 1e-4), n_touched equal {nt_eq}")
    if not (err_cd <= 1e-5 and err_a <= 1e-4 and nt_eq):
        raise SystemExit("B1 disagrees with its plain version")

    g = torch.Generator(device=dev).manual_seed(1)
    gout = torch.randn(out_k.shape, generator=g, device=dev)
    gr_k = raster_cuda.composite_bwd(packets, tile_ids, counts, ntx, gout,
                                     out_k)
    gr_p = R.composite_bwd_torch(packets, tile_ids, counts, ntx, gout, out_k)
    torch.cuda.synchronize()
    err_g = (gr_k - gr_p).abs().max().item()
    ok_g = bool(torch.allclose(gr_k, gr_p, rtol=1e-3, atol=1e-4))
    log(f"B2 vs plain: grad max|err| {err_g:.3e} max|grad| "
        f"{gr_p.abs().max().item():.3e} allclose(rtol 1e-3, atol 1e-4) {ok_g}")
    if not ok_g:
        raise SystemExit("B2 disagrees with its plain version")

    ms_f = cuda_ms(lambda: raster_cuda.composite_fwd(packets, tile_ids,
                                                      counts, ntx))
    ms_fp = cuda_ms(lambda: R.composite_fwd_torch(packets, tile_ids, counts,
                                                  ntx), reps=10, warmup=1)
    ms_b = cuda_ms(lambda: raster_cuda.composite_bwd(packets, tile_ids,
                                                      counts, ntx, gout,
                                                      out_k))
    ms_bp = cuda_ms(lambda: R.composite_bwd_torch(packets, tile_ids, counts,
                                                  ntx, gout, out_k),
                    reps=10, warmup=1)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    n_in = packets.numel() * 4 + tile_ids.numel() * 4 + counts.numel() * 4
    fwd_bytes = n_in + out_k.numel() * 4 + nt_k.numel() * 4
    bwd_bytes = n_in + gout.numel() * 4 + out_k.numel() * 4 + gr_k.numel() * 4
    bf, bf_by = bound(fwd_bytes, pairs * FWD_OPS_PER_PAIR)
    bb, bb_by = bound(bwd_bytes, pairs * BWD_OPS_PER_PAIR)
    log(f"B1 {ms_f:.3f} ms (plain {ms_fp:.3f} ms, bound {bf:.3f} ms by "
        f"{bf_by}); B2 {ms_b:.3f} ms (plain {ms_bp:.3f} ms, bound {bb:.3f} "
        f"ms by {bb_by})")
    src = "splatslam_tpu_torch/csrc/composite.cu"
    return [
        dict(name="composite_fwd", route="cuda", source=src,
             replaces="splatslam_tpu/ops/raster_pallas.py:333",
             max_abs_err=max(err_cd, err_a), ms=ms_f, plain_ms=ms_fp,
             bound_ms=bf, bound_by=bf_by, library_ms=None),
        dict(name="composite_bwd", route="cuda", source=src,
             replaces="splatslam_tpu/ops/raster_pallas.py:387",
             max_abs_err=err_g, ms=ms_b, plain_ms=ms_bp,
             bound_ms=bb, bound_by=bb_by, library_ms=None),
    ]


def main_path(dev):
    """replica_scale.yaml through the port's SLAM at full width and full
    depth. Returns (launch counts of every kernel in that run, the SLAM
    object)."""
    import torch
    from splatslam_tpu_torch import slam as slam_mod
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R

    cfg = load_config(os.path.join(HERE, "configs/Synthetic/replica_scale.yaml"),
                      os.path.join(HERE, "configs/splat_slam.yaml"))
    cfg["data"]["output"] = os.path.join(HERE, "chiprun_out", "smoke_output")
    cfg["verbose"] = False
    log("main path cuts (depth only): none")
    mp, tr = cfg["mapping"], cfg["mapping"]["Training"]
    log(f"main path widths: {cfg['cam']['H_out']}x{cfg['cam']['W_out']} "
        f"capacity {mp['capacity']} raster_K {mp['raster_K']} window "
        f"{tr['window_size']} mapping_itr_num {tr['mapping_itr_num']} "
        f"init_itr_num {tr['init_itr_num']} final_refine_iters "
        f"{mp['final_refine_iters']} frames {cfg['synthetic']['n_frames']}")

    raster_cuda.reset_launch_counts()
    for k in R.plain_calls:
        R.plain_calls[k] = 0
    t0 = time.perf_counter()
    slam = slam_mod.SLAM(cfg, device=dev)
    res = slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(raster_cuda.launches)
    plain = dict(R.plain_calls)
    log(f"main path: frames {res['n_frames']} keyframes {res['n_keyframes']} "
        f"mapped {len(slam.mapper.viewpoints)} wall {wall:.1f} s fps "
        f"{res['n_frames'] / wall:.3f}")
    log("phase timers (s): " + json.dumps(res["timers"]))
    log(f"kf-ATE {res['ate_rmse']} PSNR {res['psnr']} SSIM {res['ssim']} "
        f"depth-L1 {res['depth_l1']} proxy depth-L1 {res['proxy_depth_l1']}")
    log(f"launches on the main path: {counts}; plain compositing calls "
        f"{plain}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("ate_rmse", "psnr", "depth_l1"):
        v = res[name]
        if v is None or not math.isfinite(v):
            raise SystemExit(f"main path result {name} is not finite: {v}")
    # oracle tracking recovers the GT trajectory (the JAX suite holds its
    # own oracle run to the same bound, tests/test_tracking.py)
    if res["ate_rmse"] > 0.01:
        raise SystemExit(f"kf-ATE {res['ate_rmse']} above 0.01")
    if res["n_keyframes"] < 2:
        raise SystemExit("main path admitted fewer than two keyframes")
    if min(counts.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: {counts}")
    if any(plain.values()):
        raise SystemExit(f"the main path ran a plain compositor: {plain}")
    return counts, slam


def profile_phase(slam, iters=8):
    """torch.profiler over `iters` mapping iterations of the final window:
    device kernel time by name and the device's busy share."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from splatslam_tpu_torch.mapping import mapper as M
    mp = slam.mapper
    cams = [mp.viewpoints[k] for k in mp.current_window]
    w2cs, imgs, deps, expo, use_exp, valid = mp._stack_cams(cams)
    B = len(cams)
    z = lambda n: torch.zeros((B, n), device=w2cs.device)
    op = mp.opt
    lrs = dict(xyz=op["position_lr_final"], f_dc=op["feature_lr"],
               f_rest=op["feature_lr"] / 20.0, opacity=op["opacity_lr"],
               scaling=op["scaling_lr"] * 6.0, rotation=op["rotation_lr"])

    def run():
        M.map_step_n(mp.st, (z(2), z(2)), (z(6), z(6)), w2cs, imgs, deps,
                     expo, use_exp, valid, torch.zeros_like(valid),
                     mp.intrinsics, lrs, (0.0, 0.0), mp.iteration_count,
                     iters, 10.0, H=mp.H, W=mp.W, K=mp.K, use_ssim=False,
                     alpha=mp.alpha, rebin_every=mp.rebin_every,
                     max_span=mp.max_span)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    # device-side kernel events only (operator rows repeat their kernels)
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"profile: {iters} map iterations, {B} cameras: wall {wall * 1e3:.1f}"
        f" ms, device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(r[2] for r in rows)} kernel launches")
    for t, name, n in rows[:12]:
        log(f"  {t / 1e3:9.2f} ms  x{n:<5d} {name[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import splatslam_tpu_torch  # noqa: F401  (fails outside the repo)
    for mod in ("jax", "splatslam_tpu"):
        if mod in sys.modules:
            raise SystemExit(f"{mod} was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    log("card: " + card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"kernel build: {build_kernels():.1f} s")
    kernels = kernel_phase(dev)
    counts, slam = main_path(dev)
    profile_phase(slam)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    for mod in ("jax", "splatslam_tpu"):
        if mod in sys.modules:
            raise SystemExit(f"{mod} was imported")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
