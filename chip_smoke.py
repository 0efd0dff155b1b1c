"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                  # kernels + the main path (one card)
    python3 chip_smoke.py --kernels-only   # phases 1-3 only
    python3 chip_smoke.py --learned-only   # phases 1-2 and 7-8 only
    python3 chip_smoke.py --kernels-only "--time-flags= |-fmad=true"
        # also time the kernels built with other nvcc flags (here: the
        # port's own and -fmad=true) and report how far their results move
    python3 chip_smoke.py --kernels-only --sweep-pixels-per-thread
        # also time each kernel at every number of pixels per thread it is
        # built for, on 1 to 10 cameras of the kernel-phase input: what
        # raster_cuda.pixels_per_thread's thresholds rest on

Phases, each unguarded (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA source under splatslam_tpu_torch/csrc/ (one nvcc
     per source, all started together);
  3. kernel phase: B1/B2 (3DGS tile compositor forward/backward) on a real
     input at replica_scale shapes (10 cameras, 320x640, K=256, capacity
     131072), binned from a seeded Gaussian cloud by the port's bin_batch,
     held against their plain PyTorch versions on the card, then timed
     with CUDA events (warm-up, median of 10), B1 with and without
     n_touched; then the same on one camera of that input, the grid of most
     of the main path's launches;
  4. main path: configs/Synthetic/replica_scale.yaml through the port's
     SLAM at full width and full depth, with every kernel launch count
     reset just before and read just after;
  5. the kernel phase again on the main path's own final keyframe window
     (its map, cameras and tile lists as map_step_n bins them), so the
     kernels are also checked and timed at the density the path runs;
  6. a torch.profiler window over a few mapping iterations of that window
     (device time by kernel, device busy share);
  7. learned path: configs/Synthetic/smoke.yaml (DroidNet admission and
     update rounds, loop closure, final BA, mapping, refine, every
     evaluation and the trajectory filler) through the port's SLAM, uncut,
     with the launch counts reset just before and read just after; then
     B1/B2 against their plain versions on this run's final window;
  8. network phase: the encoders on one 240x320 and one 320x640 frame, one
     update-operator call on the learned run's last frontend graph and one
     alt_corr chunk of it, timed with CUDA events (median of 10); the same
     update-operator call in float32 against bf16; a torch.profiler window
     over one frontend update_rounds call;
  9. the kernels JSON line, then the device JSON line last.

`--learned-only` skips phases 3-6 (and prints no kernels line).

Exits non-zero without printing a result when no CUDA device is present,
or when the port's package is not beside this script.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bound_ms comes from splatslam_tpu_torch.ops.raster_cuda.kernel_bounds: the
# larger of bytes over 3.35 TB/s and FP32 operations over 67 TFLOP/s, the
# operations counted from the function's arithmetic, not from a kernel
# design: 28 (B1) or 60 (B2) for a pixel-contributor pair that carries a
# weight in this run's data (counted by B1's n_touched), 12 for one that does
# not (its evaluation and one comparison; all that follows is an exact zero).
# The log also gives the figure with every pair charged in full, which is
# what the first design's rows were held against. Beside it each kernel gets
# the time that the
# SM's load/store-and-shuffle pipe alone would need for the design in the
# tree (raster_cuda.lsu_pipe_ms): the FP32 count never limited the first
# design of these kernels, that pipe did (50 shuffles, 11 shared loads and 10
# shared stores per contributor and warp in B2), so the figure says which
# wall a kernel stands at.


def log(msg):
    print(msg, flush=True)


def smi(query, fmt="csv,noheader"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def refuse_jax():
    for mod in ("jax", "splatslam_tpu"):
        if mod in sys.modules:
            raise SystemExit(f"{mod} was imported")


def card_line():
    return smi("name,power.limit")


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


def raw_calls(lib, packets, tile_ids, counts, ntx, gout, out):
    """B1 and B2 through the C entry points of `lib` into buffers made once:
    (fwd(want_touched, pixels_per_thread), bwd(pixels_per_thread), B1's
    output buffer, B2's gradient buffer, which bwd adds to)."""
    import torch
    B, N, _ = packets.shape
    _, T, K = tile_ids.shape
    nt = torch.zeros((B, N), dtype=torch.int32, device=packets.device)
    grad = torch.zeros((B, N, 10), device=packets.device)
    o = torch.empty_like(out)
    stream = torch.cuda.current_stream().cuda_stream

    def call(err):
        if err:
            raise SystemExit(f"launch failed with CUDA error {err}")

    ptr = lambda *ts: [t.data_ptr() for t in ts]
    fwd = lambda touch, ppt: call(lib.composite_fwd(
        *ptr(packets, tile_ids, counts, o, nt), B, N, T, K, ntx, touch, ppt,
        stream))
    bwd = lambda ppt: call(lib.composite_bwd(
        *ptr(packets, tile_ids, counts, gout, out, grad), B, N, T, K, ntx,
        ppt, stream))
    return fwd, bwd, o, grad


def sweep_pixels_per_thread(packets, tile_ids, counts, ntx):
    """Times B1 (without n_touched, as most of the main path's launches)
    and B2 at every number of pixels per thread they are built for, on the
    first 1 to 10 cameras of the input, without output allocation."""
    import torch
    from splatslam_tpu_torch.ops import raster_cuda
    lib = raster_cuda.bind(raster_cuda.build())
    for B in (1, 2, 3, 4, 6, 8, 10):
        pk, ids, cn = (x[:B].contiguous() for x in (packets, tile_ids,
                                                    counts))
        out, _ = raster_cuda.composite_fwd(pk, ids, cn, ntx)
        gout = torch.ones_like(out)
        fwd, bwd, _, _ = raw_calls(lib, pk, ids, cn, ntx, gout, out)
        ms = {("composite_fwd", p): cuda_ms(lambda: fwd(0, p))
              for p in raster_cuda.PIXELS_PER_THREAD["composite_fwd"]}
        ms.update({("composite_bwd", p): cuda_ms(lambda: bwd(p))
                   for p in raster_cuda.PIXELS_PER_THREAD["composite_bwd"]})
        log(f"pixels per thread, {B} cameras ({B * counts.shape[1]} tiles): "
            + ", ".join(f"{k} at {p}: {t:.3f} ms" + (
                " (chosen)" if raster_cuda.pixels_per_thread(
                    k, B * counts.shape[1]) == p else "")
                for (k, p), t in ms.items()))


def time_other_flags(flags, packets, tile_ids, counts, ntx, gout, out):
    """Times B1/B2 built with other nvcc flags, through the raw C entry
    points, and reports how far their results are from the port's build:
    what a flag of the port's build costs."""
    import torch
    from splatslam_tpu_torch.ops import raster_cuda
    src = raster_cuda.SOURCES[0]
    tag = hashlib.sha256(" ".join(flags).encode()).hexdigest()[:8]
    raster_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = raster_cuda.BUILD_DIR / f"lib{src.stem}_timed_{tag}.so"
    subprocess.run([raster_cuda._nvcc(), *flags, "-o", str(target), str(src)],
                   check=True)
    B, T = counts.shape
    ppt = {k: raster_cuda.pixels_per_thread(k, B * T)
           for k in ("composite_fwd", "composite_bwd")}
    fwd, bwd, o, grad = raw_calls(raster_cuda.bind(target), packets,
                                  tile_ids, counts, ntx, gout, out)
    extra = [f for f in flags if f not in raster_cuda.NVCC_FLAGS]
    ms = (cuda_ms(lambda: fwd(1, ppt["composite_fwd"])),
          cuda_ms(lambda: fwd(0, ppt["composite_fwd"])),
          cuda_ms(lambda: bwd(ppt["composite_bwd"])))
    grad.zero_()
    bwd(ppt["composite_bwd"])
    ref = raster_cuda.composite_bwd(packets, tile_ids, counts, ntx, gout, out)
    log(f"built with {extra or 'the port\'s flags'} (no output allocation "
        f"in these calls): B1 {ms[0]:.3f} ms, B1 without n_touched "
        f"{ms[1]:.3f} ms, B2 {ms[2]:.3f} ms; against the port's build: "
        f"image max|diff| {(o - out).abs().max().item():.3e}, grad max|diff| "
        f"{(grad - ref).abs().max().item():.3e}, grad allclose(rtol 1e-3, "
        f"atol 1e-4) {bool(torch.allclose(grad, ref, rtol=1e-3, atol=1e-4))}")


def kernel_phase(label, packets, tile_ids, counts, ntx, time_flags=None):
    """B1/B2 on one input: held against their plain versions, then timed.
    Returns the measurements by kernel name."""
    import torch
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R
    dev = packets.device
    B, N, _ = packets.shape
    _, T, K = tile_ids.shape
    pairs = int(torch.clamp(counts, max=K).sum()) * R.NPIX
    log(f"{label} input: B={B} T={T} K={K} N={N} mean count "
        f"{counts.float().mean().item():.1f} overflow tiles "
        f"{int((counts > K).sum())} pixel-contributor pairs {pairs}")

    out_k, nt_k = raster_cuda.composite_fwd(packets, tile_ids, counts, ntx)
    out_n, nt_n = raster_cuda.composite_fwd(packets, tile_ids, counts, ntx,
                                            want_touched=False)
    out_p, nt_p = R.composite_fwd_torch(packets, tile_ids, counts, ntx)
    torch.cuda.synchronize()
    err_cd = (out_k[:, :, :4] - out_p[:, :, :4]).abs().max().item()
    err_a = (out_k[:, :, 4] - out_p[:, :, 4]).abs().max().item()
    nt_eq = bool(torch.equal(nt_k, nt_p))
    log(f"pairs with a weight > 0: {100 * int(nt_k.sum()) / pairs:.2f}% of "
        f"the pairs")
    no_touch_ok = bool(torch.equal(out_n, out_k)) and not bool(nt_n.any())
    log(f"B1 vs plain: color/depth max|err| {err_cd:.3e} (tol 1e-5), alpha "
        f"max|err| {err_a:.3e} (tol 1e-4), n_touched equal {nt_eq}; without "
        f"n_touched: same image and zero counts {no_touch_ok}")
    if not (err_cd <= 1e-5 and err_a <= 1e-4 and nt_eq and no_touch_ok):
        raise SystemExit(f"B1 disagrees with its plain version ({label})")

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
        raise SystemExit(f"B2 disagrees with its plain version ({label})")

    fwd = lambda **kw: raster_cuda.composite_fwd(packets, tile_ids, counts,
                                                 ntx, **kw)
    ms_f = cuda_ms(fwd)
    ms_fn = cuda_ms(lambda: fwd(want_touched=False))
    ms_fp = cuda_ms(lambda: R.composite_fwd_torch(packets, tile_ids, counts,
                                                  ntx), reps=10, warmup=1)
    ms_b = cuda_ms(lambda: raster_cuda.composite_bwd(packets, tile_ids,
                                                      counts, ntx, gout,
                                                      out_k))
    ms_bp = cuda_ms(lambda: R.composite_bwd_torch(packets, tile_ids, counts,
                                                  ntx, gout, out_k),
                    reps=10, warmup=1)
    bounds = raster_cuda.kernel_bounds(B, N, T, K, pairs, int(nt_k.sum()))
    full = raster_cuda.kernel_bounds(B, N, T, K, pairs)
    clock = float(smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    pipe = {k: raster_cuda.lsu_pipe_ms(k, pairs, clock, B * T) for k in bounds}
    issues = {k: raster_cuda.lsu_issues_per_32_pairs(k, B * T) for k in bounds}
    ppt = {k: raster_cuda.pixels_per_thread(k, B * T) for k in bounds}
    (bf, bf_by), (bb, bb_by) = (bounds["composite_fwd"],
                                bounds["composite_bwd"])
    log(f"B1 {ms_f:.3f} ms, without n_touched {ms_fn:.3f} ms (plain "
        f"{ms_fp:.3f} ms, bound {bf:.3f} ms by {bf_by}); B2 {ms_b:.3f} ms "
        f"(plain {ms_bp:.3f} ms, bound {bb:.3f} ms by {bb_by}); with every "
        f"pair charged in full the bounds would be "
        f"{full['composite_fwd'][0]:.3f} and {full['composite_bwd'][0]:.3f} "
        f"ms")
    log("load/store-and-shuffle pipe alone at "
        f"{clock / 1e9:.3f} GHz: " + ", ".join(
            f"{k} ({ppt[k]} pixels per thread) {issues[k]:.3f} issues per 32 "
            f"pairs = {pipe[k]:.3f} ms" for k in pipe))
    for flags in time_flags or ():
        time_other_flags(flags, packets, tile_ids, counts, ntx, gout, out_k)
    return {
        "composite_fwd": dict(
            max_abs_err=max(err_cd, err_a), ms=ms_f, ms_no_touched=ms_fn,
            plain_ms=ms_fp, bound_ms=bf, bound_by=bf_by, library_ms=None,
            pairs=pairs),
        "composite_bwd": dict(
            max_abs_err=err_g, ms=ms_b, plain_ms=ms_bp, bound_ms=bb,
            bound_by=bb_by, library_ms=None, pairs=pairs),
    }


def window_input(slam):
    """Packets and tile lists of the main path's final keyframe window, as
    map_step_n's loop makes them: (packets, tile_ids, counts, ntx)."""
    import torch
    from splatslam_tpu_torch.mapping import gaussians as G, mapper as M
    from splatslam_tpu_torch.ops import rasterizer as R
    mp = slam.mapper
    st = mp.st
    with torch.no_grad():
        w2cs = mp._stack_cams([mp.viewpoints[k]
                               for k in mp.current_window])[0]
        B, N = w2cs.shape[0], st.capacity
        tile_ids, counts = M._rebin(st, w2cs, mp.intrinsics, H=mp.H, W=mp.W,
                                    K=mp.K, margin=4.0,
                                    rebin_every=mp.rebin_every,
                                    max_span=mp.max_span)
        m2d, dz, conic, _, _ = R.project_gaussians(
            st.xyz, G.get_scaling(st), st.rotation, w2cs, mp.intrinsics,
            mp.H, mp.W)
        cols = M._colors(st.f_dc, st.f_rest, st.xyz, w2cs, mp.sh_degree)
        if cols.dim() == 2:
            cols = cols[None].expand(B, N, 3)
        packets = R.make_packets(m2d, conic, cols, G.get_opacity(st)[:, 0],
                                 dz)
    return packets, tile_ids, counts, (mp.W + R.TILE - 1) // R.TILE


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


def profile_run(label, run):
    """torch.profiler over one call of `run` (after one warm-up call):
    device kernel time by name and the device's busy share."""
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    # device-side kernel events only (operator rows repeat their kernels)
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"profile: {label}: wall {wall * 1e3:.1f}"
        f" ms, device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(r[2] for r in rows)} kernel launches")
    for t, name, n in rows[:12]:
        log(f"  {t / 1e3:9.2f} ms  x{n:<5d} {name[:90]}")


def profile_phase(slam, iters=8):
    """torch.profiler over `iters` mapping iterations of the final window."""
    import torch
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

    profile_run(f"{iters} map iterations, {B} cameras", run)


LEARNED_WEIGHTS = "pretrained/droid_dba.msgpack"


def learned_path(dev):
    """configs/Synthetic/smoke.yaml, uncut, through the port's SLAM with the
    learned tracker in its default dtype. Returns (launch counts of every
    kernel in that run, the SLAM object)."""
    import torch
    from splatslam_tpu_torch import slam as slam_mod
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.models.droid_net import compute_dtype
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R

    cfg = load_config(os.path.join(HERE, "configs/Synthetic/smoke.yaml"),
                      os.path.join(HERE, "configs/splat_slam.yaml"))
    cfg["data"]["output"] = os.path.join(HERE, "chiprun_out",
                                         "smoke_output_learned")
    cfg["verbose"] = False
    cfg["eval_full_traj"] = True
    if cfg["tracking"].get("oracle", False):
        raise SystemExit("smoke.yaml is not a learned-tracking config")
    mp, tr, tk = cfg["mapping"], cfg["mapping"]["Training"], cfg["tracking"]
    log(f"learned path widths: {cfg['cam']['H_out']}x{cfg['cam']['W_out']} "
        f"frames {cfg['synthetic']['n_frames']} buffer {tk['buffer']} "
        f"warmup {tk['warmup']} capacity {mp['capacity']} raster_K "
        f"{mp['raster_K']} window {tr['window_size']} mapping_itr_num "
        f"{tr['mapping_itr_num']} init_itr_num {tr['init_itr_num']} "
        f"final_refine_iters {mp['final_refine_iters']} network dtype "
        f"{compute_dtype()}; cuts: none")

    raster_cuda.reset_launch_counts()
    for k in R.plain_calls:
        R.plain_calls[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slam = slam_mod.SLAM(cfg, device=dev)
    res = slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(raster_cuda.launches)
    plain = dict(R.plain_calls)
    log(f"learned path: weights {res['weights']} frames {res['n_frames']} "
        f"keyframes {res['n_keyframes']} mapped "
        f"{len(slam.mapper.viewpoints)} wall {wall:.1f} s fps "
        f"{res['n_frames'] / wall:.3f}")
    log("learned path phase timers (s): " + json.dumps(res["timers"]))
    log(f"learned path: kf-ATE {res['ate_rmse']} full ATE "
        f"{res['full_ate_rmse']} PSNR {res['psnr']} SSIM {res['ssim']} "
        f"depth-L1 {res['depth_l1']} proxy depth-L1 {res['proxy_depth_l1']}")
    log(f"launches on the learned path: {counts}; plain compositing calls "
        f"{plain}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if res["weights"] != LEARNED_WEIGHTS:
        raise SystemExit(f"learned path ran on weights {res['weights']!r}, "
                         f"not {LEARNED_WEIGHTS}")
    if slam.model.dtype != compute_dtype():
        raise SystemExit(f"network dtype {slam.model.dtype}")
    for name in ("ate_rmse", "full_ate_rmse", "psnr", "ssim", "depth_l1",
                 "proxy_depth_l1"):
        v = res[name]
        if v is None or not math.isfinite(v):
            raise SystemExit(f"learned path result {name} is not finite: {v}")
    for name in ("motion_filter", "fe.rounds", "final_ba", "full_traj_eval"):
        if name not in res["timers"]:
            raise SystemExit(f"learned path never ran phase {name}")
    if res["n_keyframes"] <= tk["warmup"]:
        raise SystemExit(f"learned path admitted {res['n_keyframes']} "
                         f"keyframes, warmup is {tk['warmup']}")
    # the JAX suite's own absolute bound for the learned tracker
    if res["ate_rmse"] > 0.25:
        raise SystemExit(f"learned path kf-ATE {res['ate_rmse']} above 0.25")
    if min(counts.values()) <= 0:
        raise SystemExit(f"a kernel never launched on the learned path: "
                         f"{counts}")
    if any(plain.values()):
        raise SystemExit(f"the learned path ran a plain compositor: {plain}")
    return counts, slam


def network_phase(slam, dev):
    """Times of the tracking network's pieces at the learned path's shapes,
    bf16 against float32 on one update-operator call, and a profile of one
    frontend update_rounds call."""
    import torch
    from splatslam_tpu_torch.models.droid_net import normalize_images
    from splatslam_tpu_torch.models.weights import load_droid_params
    from splatslam_tpu_torch.ops import corr as corr_ops
    from splatslam_tpu_torch.tracking import factor_graph as FG
    from splatslam_tpu_torch.tracking.depth_video import reproject

    model = slam.model
    g = torch.Generator(device="cpu").manual_seed(0)
    for H, W in ((240, 320), (320, 640)):
        img = torch.randint(0, 256, (1, H, W, 3), generator=g,
                            dtype=torch.uint8).to(dev)
        with torch.no_grad():
            x = normalize_images(img)
            ms_f = cuda_ms(lambda: model.features(x))
            ms_c = cuda_ms(lambda: model.context(x))
        log(f"network ({model.dtype}): {H}x{W} frame: features {ms_f:.3f} ms,"
            f" context {ms_c:.3f} ms")

    graph = slam.frontend.graph
    v = slam.video
    s = v.state
    E = len(graph.ii)
    if E == 0:
        raise SystemExit("the learned run's frontend graph has no edges")
    ii, jj = graph._idx(graph.ii), graph._idx(graph.jj)
    h, w = s.disps.shape[-2:]

    def operator(m):
        with torch.no_grad():
            return FG.update_operator(m, s.poses, s.disps, v.intr0, s.fmaps,
                                      s.inps, graph.net, graph.target, ii, jj)

    ms_op = cuda_ms(lambda: operator(model))
    with torch.no_grad():
        pyr, ii_r, jj_r = FG.edge_frames(s.fmaps, ii, jj)
        coords1, _ = reproject(s.poses, s.disps, v.intr0, ii, jj)
        n = min(E, FG.corr_chunk(h, w))
        ms_corr = cuda_ms(lambda: corr_ops.alt_corr(
            pyr, ii_r[:n], jj_r[:n], coords1[:n]))
    log(f"network ({model.dtype}): update_operator on the last frontend "
        f"graph ({E} edges, {len(set(graph.ii.tolist()))} source keyframes, "
        f"{h}x{w}) {ms_op:.3f} ms; alt_corr on one chunk of {n} edges "
        f"{ms_corr:.3f} ms")

    m32 = load_droid_params(slam.cfg["tracking"].get("pretrained", ""),
                            device=dev, dtype=torch.float32)
    out16, out32 = operator(model), operator(m32)
    ms_op32 = cuda_ms(lambda: operator(m32))
    # delta = target' - coords1, weight
    d16, d32 = out16[1] - out16[6], out32[1] - out32[6]
    d_err = (d16 - d32).abs().max().item()
    w_err = (out16[2] - out32[2]).abs().max().item()
    log(f"update_operator {model.dtype} against float32 ({ms_op32:.3f} ms): "
        f"max|delta diff| {d_err:.4f} px at max|delta| "
        f"{d32.abs().max().item():.3f}, mean|delta diff| "
        f"{(d16 - d32).abs().mean().item():.5f}; max|weight diff| "
        f"{w_err:.4f}")
    for t in (d16, d32, out16[2], out32[2]):
        if not bool(torch.isfinite(t).all()):
            raise SystemExit("update_operator gave a non-finite value")

    rounds = slam.frontend._rounds(slam.frontend.iters1)

    def run():
        graph.update_rounds(rounds, None, None, use_inactive=True)
        torch.cuda.synchronize()

    profile_run(f"one frontend update_rounds call ({len(rounds)} rounds, "
                f"{E} edges)", run)


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase")
    ap.add_argument("--learned-only", action="store_true",
                    help="only the build, the learned path and the network "
                    "phase")
    ap.add_argument("--time-flags", default=None,
                    help="extra nvcc flags (space-separated; several sets "
                    "separated by '|', an empty set is the port's own "
                    "flags) for further builds that are timed beside the "
                    "port's; a -fmad flag replaces the port's")
    ap.add_argument("--sweep-pixels-per-thread", action="store_true",
                    help="time each kernel at every number of pixels per "
                    "thread it is built for, on 1 to 10 cameras")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import splatslam_tpu_torch  # noqa: F401  (fails outside the repo)
    refuse_jax()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    log("card: " + card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"kernel build: {build_kernels():.1f} s")
    from splatslam_tpu_torch.ops import raster_cuda
    time_flags = []
    for extra in args.time_flags.split("|") if args.time_flags else ():
        extra = extra.split()
        drop = {"-fmad=false"} if any(f.startswith("-fmad") for f in extra) \
            else set()
        time_flags.append([f for f in raster_cuda.NVCC_FLAGS if f not in drop]
                          + extra)
    if args.learned_only:
        _, learned = learned_path(dev)
        kernel_phase("learned final window", *window_input(learned))
        network_phase(learned, dev)
        refuse_jax()
        return 0
    inputs = kernel_input(dev)
    cloud = kernel_phase("kernel phase", *inputs, time_flags=time_flags)
    # one camera of the same cloud: the grid of the map initialisation and
    # of the final refinement, most of the main path's launches
    single = kernel_phase("one camera", *[
        x[:1].contiguous() if torch.is_tensor(x) else x for x in inputs])
    if args.sweep_pixels_per_thread:
        sweep_pixels_per_thread(*inputs)
    if args.kernels_only:
        log(json.dumps(dict(kernel_phase=cloud, one_camera=single)))
        return 0
    counts, slam = main_path(dev)
    window = kernel_phase("final window", *window_input(slam))
    profile_phase(slam)
    del slam
    torch.cuda.empty_cache()
    counts_learned, learned = learned_path(dev)
    window_learned = kernel_phase("learned final window",
                                  *window_input(learned))
    network_phase(learned, dev)
    src = "splatslam_tpu_torch/csrc/composite.cu"
    replaces = {"composite_fwd": "splatslam_tpu/ops/raster_pallas.py:333",
                "composite_bwd": "splatslam_tpu/ops/raster_pallas.py:387"}
    kernels = []
    for name, m in cloud.items():
        w = window[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=counts[name], launches_learned=counts_learned[name],
            **m,
            one_camera={k: v for k, v in single[name].items()
                        if k != "library_ms"},
            window={k: v for k, v in w.items() if k != "library_ms"},
            learned_window={k: v for k, v in window_learned[name].items()
                            if k != "library_ms"}))
    refuse_jax()
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
