"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                  # kernels + the main path (one card)
    python3 chip_smoke.py --kernels-only   # phases 1-3 only
    python3 chip_smoke.py --learned-only   # phases 1-2 and 7-8 only
    python3 chip_smoke.py --prior-only     # phases 1-2 and 9-12 only
    python3 chip_smoke.py --train-only     # phases 1-2 and 13 only
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
  9. prior path: configs/Synthetic/smoke.yaml with, set in memory, the
     `dpt` mono prior (the full-width DPT-hybrid network on seeded weights,
     no checkpoint ships) and meshing on, through the port's SLAM, uncut,
     launch counts reset just before and read just after; gates: the run
     ends, its results are finite, one saved depth per prior call and the
     provider marker are on disk, mesh.ply has faces, both kernels launched.
     No accuracy gate (a random prior with `mono_thres` off); its accuracy
     is printed beside the learned path's. Then B1/B2 against their plain
     versions on this run's final window;
 10. DPT phase: one 240x320 and one 320x640 Synthetic frame through the
     predictor on the card against the same seeded module on the CPU in
     float32 (network output before the clamp and final depth, tolerance
     1e-3 of the output's maximum), then timed with CUDA events (median of
     10) in float32 and under bf16 autocast, with the difference between
     the two, the FLOPs PyTorch counts for one forward pass and a
     torch.profiler window over one float32 call;
 11. mesh phase: the prior path's final map fused into a TSDF again: device
     milliseconds of one `integrate`, host seconds of the extraction, grid
     dims, voxel size, peak memory;
 12. recorded-sequence phase: a TUM-RGBD tree (jittered timestamps, a
     `distortion` entry) written from the first 20 frames of the smoke
     scene, read back by the port's TUM_RGBD reader and run through SLAM
     with the `files` prior on the depths the prior path's provider saved;
 13. trainer phase (the tracker's self-trainer, plain PyTorch under
     autograd in float32, no kernel of its own):
     (a) one flow step (96x128, batch 2, 8 iterations) and one DBA step
         (96x128, N=7, 4 rounds, one scene) from the same seeded
         parameters and batch on the card and on the CPU: loss, EPE/ATE
         and pre-clip gradient norm within 1e-5 relative (flow), 1e-3
         (DBA loss and ATE) and 5e-3 (DBA gradient norm); every gradient
         tensor within 2e-3 of its max |g| (flow), 2e-2 (DBA, update
         operator) or 2e-1 (DBA, encoders), or three times what a 1e-6
         perturbation of the parameters moves it on the CPU (printed
         beside: float32 does not reproduce the DBA step's gradients
         better); the biases ahead of an
         InstanceNorm, zero analytically, below 1e-6 of the largest
         gradient;
     (b) descent: train(steps=8, batch=2, 64x96, lr 4e-4, pool=1), the
         last EPE below the first;
     (c) the flow stage at train_droid.py's defaults (batch 4, both
         FLOW_BUCKETS, 8 iterations, lr 2e-4), 12 steps on a pool of 2
         batches per bucket: ms per step per bucket (CUDA-synchronised,
         median after each bucket's first two steps), the pool's host
         render time, peak memory, the loss/EPE history;
     (d) the DBA stage at its defaults (batch 2, N=7, 8 rounds, lr 5e-5,
         both buckets, pool 2 per bucket), 8 steps from (c)'s checkpoint:
         ms per step per bucket, ATE history; gates: gnorm > 0, the weight
         and eta heads moved;
     (e) (d)'s .msgpack read back by load_droid_params in float32,
         bit-identical to the trained net, and in bf16 one update_step;
     (f) torch.profiler over one flow step and one DBA step at 240x320
         (device busy share, launches, top kernels) and their FLOPs by
         FlopCounterMode;
     every file under pretrained/ hashes the same before and after the
     script;
 14. the kernels JSON line, then the device JSON line last.

The machine this script is written for has numpy, scipy, cv2 and PIL and no
matplotlib: every path runs with `eval_plots` off (panels and trajectory
figures are drawn on a machine that has matplotlib, see the README), and
phase 12 needs cv2.

`--learned-only` skips phases 3-6 and 9-13, `--prior-only` phases 3-8 and 13,
`--train-only` phases 3-12 (none of them prints the kernels line).

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
    cfg["eval_plots"] = False
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


def profile_run(label, run, warmup=True):
    """torch.profiler over one call of `run` (after one warm-up call unless
    the caller has just made one): device kernel time by name and the
    device's busy share."""
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    if warmup:
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
    launches = sum(r[2] for r in rows)
    log(f"profile: {label}: wall {wall * 1e3:.1f}"
        f" ms, device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{launches} kernel launches")
    for t, name, n in rows[:12]:
        log(f"  {t / 1e3:9.2f} ms  x{n:<5d} {name[:90]}")
    return dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3,
                busy_share=busy / wall, launches=launches)


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
    kernel in that run, the SLAM object, its results)."""
    from splatslam_tpu_torch.models.droid_net import compute_dtype
    cfg = smoke_cfg("smoke_output_learned")
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
    counts, slam, res = run_slam("learned path", cfg, dev)
    if res["weights"] != LEARNED_WEIGHTS:
        raise SystemExit(f"learned path ran on weights {res['weights']!r}, "
                         f"not {LEARNED_WEIGHTS}")
    if slam.model.dtype != compute_dtype():
        raise SystemExit(f"network dtype {slam.model.dtype}")
    for name in ("motion_filter", "fe.rounds", "final_ba", "full_traj_eval"):
        if name not in res["timers"]:
            raise SystemExit(f"learned path never ran phase {name}")
    # the JAX suite's own absolute bound for the learned tracker
    if res["ate_rmse"] > 0.25:
        raise SystemExit(f"learned path kf-ATE {res['ate_rmse']} above 0.25")
    return counts, slam, res


FINITE = ("ate_rmse", "full_ate_rmse", "psnr", "ssim", "depth_l1",
          "proxy_depth_l1")


def run_slam(label, cfg, dev):
    """One SLAM run with every launch count reset just before and read just
    after: (launch counts, SLAM object, results). Fails on a non-finite
    result, a kernel that never launched or a plain compositor call."""
    import torch
    from splatslam_tpu_torch import slam as slam_mod
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R
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
    log(f"{label}: weights {res['weights']} frames {res['n_frames']} "
        f"keyframes {res['n_keyframes']} mapped "
        f"{len(slam.mapper.viewpoints)} wall {wall:.1f} s fps "
        f"{res['n_frames'] / wall:.3f}")
    log(f"{label} phase timers (s): " + json.dumps(res["timers"]))
    log(f"{label}: kf-ATE {res['ate_rmse']} full ATE {res['full_ate_rmse']} "
        f"PSNR {res['psnr']} SSIM {res['ssim']} depth-L1 {res['depth_l1']} "
        f"proxy depth-L1 {res['proxy_depth_l1']} mesh {res['mesh']}")
    log(f"launches on the {label}: {counts}; plain compositing calls "
        f"{plain}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in FINITE:
        v = res[name]
        if v is None or not math.isfinite(v):
            raise SystemExit(f"{label} result {name} is not finite: {v}")
    if res["n_keyframes"] <= cfg["tracking"]["warmup"]:
        raise SystemExit(f"{label} admitted {res['n_keyframes']} keyframes, "
                         f"warmup is {cfg['tracking']['warmup']}")
    if min(counts.values()) <= 0:
        raise SystemExit(f"a kernel never launched on the {label}: {counts}")
    if any(plain.values()):
        raise SystemExit(f"the {label} ran a plain compositor: {plain}")
    return counts, slam, res


def smoke_cfg(out_name):
    from splatslam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs/Synthetic/smoke.yaml"),
                      os.path.join(HERE, "configs/splat_slam.yaml"))
    cfg["data"]["output"] = os.path.join(HERE, "chiprun_out", out_name)
    cfg["verbose"] = False
    cfg["eval_plots"] = False
    cfg["eval_full_traj"] = True
    return cfg


def depth_dir(slam):
    return os.path.join(slam.save_dir, "mono_priors", "depths")


def prior_path(dev, learned_res):
    """smoke.yaml, uncut, with the `dpt` prior at full width on seeded
    weights and meshing on. Returns (launch counts, the SLAM object)."""
    import numpy as np
    cfg = smoke_cfg("smoke_output_prior")
    cfg["mono_prior"].update(provider="dpt", depth_pretrained="")
    cfg["meshing"]["mesh"] = True
    log("prior path: smoke.yaml with mono_prior.provider dpt, "
        "depth_pretrained '' (seeded full-width weights), meshing.mesh "
        "True; cuts: none")
    counts, slam, res = run_slam("prior path", cfg, dev)
    t = res["timers"]
    log(f"prior path: mono {t['mono']:.3f} s over {slam.mono._dpt.calls} "
        f"predictions, inside motion_filter {t['motion_filter']:.3f} s and "
        f"mapping {t['mapping']:.3f} s; mesh_eval {t['mesh_eval']:.3f} s")
    if learned_res is not None:
        log("prior path against the learned path (oracle prior), a record "
            "and no gate: " + ", ".join(
                f"{k} {res[k]:.4f} vs {learned_res[k]:.4f}" for k in FINITE))
    files = sorted(f for f in os.listdir(depth_dir(slam))
                   if f.endswith(".npy"))
    with open(os.path.join(depth_dir(slam), ".provider")) as f:
        marker = f.read()
    inside = []
    for name in files:
        d = np.load(os.path.join(depth_dir(slam), name))
        if d.shape != (slam.mapper.H, slam.mapper.W) or \
                not np.isfinite(d).all():
            raise SystemExit(f"saved prior {name}: shape {d.shape} or a "
                             "non-finite value")
        inside.append(float(((d > 0) & (d < 1)).mean()))
    log(f"prior path: {len(files)} saved depths for {slam.mono._dpt.calls} "
        f"predictions, marker {marker!r}; share of the prior's pixels "
        f"strictly inside (0,1): mean {np.mean(inside):.3f} min "
        f"{min(inside):.3f} max {max(inside):.3f}")
    if len(files) != slam.mono._dpt.calls or marker != "dpt":
        raise SystemExit("saved depths do not match the prior calls")
    mesh = res["mesh"]
    if mesh is None or mesh["n_faces"] <= 0 or not os.path.exists(
            os.path.join(slam.save_dir, "mesh.ply")):
        raise SystemExit(f"prior path wrote no mesh: {mesh}")
    return counts, slam


def dpt_phase(slam, dev):
    """The predictor on the card against the same seeded module on the CPU,
    then its times in float32 and under bf16 autocast, and a profile of one
    float32 forward pass."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.datasets import get_dataset
    from splatslam_tpu_torch.models.dpt import DPTDepthPredictor
    gpu = slam.mono._dpt
    cpu = DPTDepthPredictor("", device="cpu")
    n_par = sum(p.numel() for p in gpu.model.parameters())
    x = torch.zeros(1, 3, gpu.size, gpu.size, device=dev)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        gpu.model(x)
    flops = fc.get_total_flops()
    log(f"DPT: {n_par / 1e6:.1f} M parameters, {flops / 1e12:.3f} TFLOP per "
        f"{gpu.size}x{gpu.size} forward pass as PyTorch counts them "
        f"(convolutions, matmuls, attention), {flops / 67e12 * 1e3:.2f} ms at "
        "67 TFLOP/s")
    for name in ("smoke", "replica_scale"):
        cfg = load_config(
            os.path.join(HERE, f"configs/Synthetic/{name}.yaml"),
            os.path.join(HERE, "configs/splat_slam.yaml"))
        img = get_dataset(cfg)[0][1]
        H, W = img.shape[:2]
        out_g = gpu.network_output(img).cpu()
        out_c = cpu.network_output(img)
        d_g, d_c = gpu(img), cpu(img)
        top = out_c.abs().max().item()
        err_o = (out_g - out_c).abs().max().item()
        err_d = float(abs(d_g - d_c).max())
        log(f"DPT {H}x{W} card against CPU, float32: network output "
            f"max|err| {err_o:.3e} at max|out| {top:.4f} (tol 1e-3 of it), "
            f"final depth max|err| {err_d:.3e} (tol 1e-3); output > 0 on "
            f"{(out_c > 0).float().mean().item():.3f} of the pixels, inside "
            f"(0,1) on {((out_c > 0) & (out_c < 1)).float().mean().item():.3f}")
        if not (top > 0 and err_o <= 1e-3 * top and err_d <= 1e-3
                and d_g.shape == (H, W)):
            raise SystemExit(f"DPT on the card disagrees with the CPU ({name})")
        ms_net = cuda_ms(lambda: gpu.network_output(img))
        ms_all = cuda_ms(lambda: gpu(img))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out_b = gpu.network_output(img).float().cpu()
            ms_bf = cuda_ms(lambda: gpu.network_output(img))
        log(f"DPT {H}x{W}: network_output {ms_net:.3f} ms float32 "
            f"({flops / ms_net / 1e9:.1f} TFLOP/s), whole call {ms_all:.3f} "
            f"ms; bf16 autocast {ms_bf:.3f} ms, max|diff to float32| "
            f"{(out_b - out_g).abs().max().item():.4e} "
            f"({(out_b - out_g).abs().max().item() / top:.4f} of max|out|), "
            f"mean {(out_b - out_g).abs().mean().item():.4e}")

    def run():
        gpu.network_output(img)
        torch.cuda.synchronize()

    profile_run(f"one DPT network_output call, float32, {H}x{W} frame", run)


def mesh_phase(slam, dev):
    """The prior path's final map fused again: times of `integrate` and of
    the host extraction, grid dims, peak memory."""
    import numpy as np
    import torch
    from splatslam_tpu_torch.utils.eval_render import (fuse_keyframes,
                                                       _render_depth)
    from splatslam_tpu_torch.utils.mesh import clean_mesh
    mp = slam.mapper
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    vol = fuse_keyframes(mp, slam.global_scale)
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    verts, faces = vol.extract_mesh()
    t_extract = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces, _ = clean_mesh(verts, faces)
    t_clean = time.perf_counter() - t0
    cam = mp.viewpoints[mp.current_window[0]]
    with torch.no_grad():
        out = mp.render_batch([cam])
        depth, color = _render_depth(out)[0], out.color[0].clamp(0, 1)
    intr = mp.intrinsics.tolist()
    ms = cuda_ms(lambda: vol.integrate(depth, color, np.asarray(cam.w2c),
                                       intr))
    n_vox = vol.tsdf.numel()
    n_kf = sum(mp.is_kf.values())
    log(f"mesh: grid {tuple(vol.tsdf.shape)} = {n_vox / 1e6:.2f} M voxels, "
        f"voxel {vol.voxel:.5f} trunc {vol.trunc:.5f} (map units, "
        f"{slam.global_scale:.4f} m each); render + integrate of {n_kf} "
        f"keyframes {t_fuse:.3f} s; integrate {ms:.3f} ms a frame (CUDA "
        f"events, median of 10; the grid's 5 floats read and written once "
        f"are {n_vox * 40 / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s); extraction "
        f"on the host {t_extract:.3f} s + clean_mesh {t_clean:.3f} s; "
        f"{len(verts)} vertices {len(faces)} faces; device memory "
        f"{base / 2**30:.2f} GiB before, peak {peak / 2**30:.2f} GiB")
    if len(faces) <= 0:
        raise SystemExit("mesh phase extracted no face")


def write_tum_tree(root, cfg, n):
    """The first `n` frames of cfg's Synthetic scene in TUM-RGBD layout:
    rgb.txt / depth.txt / groundtruth.txt, 5 Hz with jittered timestamps."""
    import cv2
    import numpy as np
    from scipy.spatial.transform import Rotation
    from splatslam_tpu_torch.datasets import get_dataset
    ds = get_dataset(cfg)
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d))
    rng = np.random.RandomState(5)
    rgb_l, dep_l, gt_l = [], [], []
    for i in range(n):
        _, color, depth, c2w = ds[i]
        t_rgb, t_dep, t_pose = 1000.0 + 0.2 * i + rng.uniform(-0.01, 0.01, 3)
        bgr = (np.clip(color, 0, 1) * 255).astype(np.uint8)[..., ::-1]
        ok = cv2.imwrite(os.path.join(root, "rgb", f"{t_rgb:.6f}.jpg"), bgr,
                         [cv2.IMWRITE_JPEG_QUALITY, 97])
        ok &= cv2.imwrite(os.path.join(root, "depth", f"{t_dep:.6f}.png"),
                          np.round(depth * 5000.0).astype(np.uint16))
        if not ok:
            raise SystemExit("cv2 could not write the TUM tree")
        rgb_l.append(f"{t_rgb:.6f} rgb/{t_rgb:.6f}.jpg")
        dep_l.append(f"{t_dep:.6f} depth/{t_dep:.6f}.png")
        q = Rotation.from_matrix(c2w[:3, :3]).as_quat()
        gt_l.append(f"{t_pose:.6f} " + " ".join(
            f"{v:.9f}" for v in (*c2w[:3, 3], *q)))
    for name, lines, head in (
            ("rgb.txt", rgb_l, ""), ("depth.txt", dep_l, ""),
            ("groundtruth.txt", gt_l, "# timestamp tx ty tz qx qy qz qw\n")):
        with open(os.path.join(root, name), "w") as f:
            f.write(head + "\n".join(lines) + "\n")


def recorded_path(prior, dev, n=20):
    """A TUM-RGBD tree of the smoke scene's first `n` frames through the
    port's reader and SLAM with the `files` prior, on depths saved by the
    prior path's provider. Returns the launch counts."""
    import shutil
    import numpy as np
    from splatslam_tpu_torch.datasets import TUM_RGBD
    root = os.path.join(HERE, "chiprun_out", "tum_tree")
    shutil.rmtree(root, ignore_errors=True)
    write_tum_tree(root, prior.cfg, n)
    # the `files` prior needs a depth for whichever frame gets admitted
    for i in range(n):
        prior.mono(i)
    cfg = smoke_cfg("smoke_output_recorded")
    cfg.update(dataset="tumrgbd", scene="tum_tree", max_frames=n)
    cfg["cam"].update(png_depth_scale=5000.0,
                      distortion=[-0.005, 0.0, 0.0, 0.0, 0.0])
    cfg["data"].update(dataset_root=root, input_folder="")
    cfg["mono_prior"]["provider"] = "files"
    out = os.path.join(cfg["data"]["output"], "tum_tree", "mono_priors")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.dirname(depth_dir(prior)), out)
    log(f"recorded path: {n} frames of the smoke scene as a TUM-RGBD tree "
        f"(jpg quality 97, 16-bit depth at 5000/m, jittered timestamps, "
        f"distortion {cfg['cam']['distortion']}), provider files on the "
        "prior path's saved depths")
    counts, slam, _ = run_slam("recorded path", cfg, dev)
    if not isinstance(slam.stream, TUM_RGBD) or len(slam.stream) != n:
        raise SystemExit(f"recorded path read {len(slam.stream)} frames "
                         f"through {type(slam.stream).__name__}")
    gt0 = slam.stream.get_gt_pose(0)
    if not np.array_equal(gt0, np.eye(4, dtype=np.float32)):
        raise SystemExit("the TUM reader did not normalise the first pose")
    return counts


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


# ---------------------------------------------------------------------------
# phase 13: the tracker's self-trainer
# ---------------------------------------------------------------------------

def pretrained_hashes():
    """SHA-256 of every file under pretrained/ (the trainer phase writes to
    a temporary directory only)."""
    out = {}
    for root, _, files in os.walk(os.path.join(HERE, "pretrained")):
        for f in sorted(files):
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, HERE)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _zero_by_norm(name):
    """fnet's conv biases but the last feed an InstanceNorm: zero gradient
    analytically."""
    return name.startswith("fnet.") and name.endswith(".bias") \
        and name != "fnet.conv2.bias"


def _loss_and_grads(model, fn):
    import torch
    model.zero_grad(set_to_none=True)
    loss, metric = fn(model)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().cpu() for n, p in model.named_parameters()}
    gnorm = float(torch.linalg.vector_norm(
        torch.cat([g.reshape(-1) for g in grads.values()]),
        dtype=torch.float64))
    return float(loss.detach()), float(metric.detach()), gnorm, grads


def trainer_parity(dev):
    """(a): one flow step and one DBA step on the card against the same on
    the CPU, from one set of seeded float32 parameters and one batch.

    Loss, metric and gradient norm are held to 1e-5 relative in the flow
    step; in the DBA step loss and ATE to 1e-3 and the gradient norm to
    5e-3 (its float32 floor is ~1e-3: tests/test_torch_train.py measured
    the port's float32 value 7.5e-4 from its float64 one). Each gradient
    tensor is held to a share of its max |g|: 2e-3 in the flow step; in
    the DBA step 2e-2 for the update operator and 2e-1 for the encoders,
    or three times the witness where that is more. The DBA step's
    gradients are not reproducible in float32 to 1e-2: a 1e-6 relative
    perturbation of the parameters (the witness, run here on the CPU and
    printed beside each gap) moves the update operator's by up to ~5e-3
    of their max and the encoders' by up to ~5e-2. 2e-1 still catches a
    gradient the card computes wrong or not at all, an error of order 1;
    the port against the JAX package is tests/test_torch_train.py's."""
    import numpy as np
    import torch
    from splatslam_tpu_torch.models.weights import init_params
    from splatslam_tpu_torch.train import droid_trainer as T

    cpu = init_params(torch.Generator().manual_seed(0), device="cpu")
    card = init_params(torch.Generator().manual_seed(0), device=dev)
    witness = init_params(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in witness.parameters():
            p.mul_(1.0 + 1e-6 * torch.randn(p.shape, generator=g))
    pair = T.make_pair_batch(np.random.RandomState(0), 2, 96, 128)
    seq = [x[0] for x in T.make_seq_batch(np.random.RandomState(0), 1, 7,
                                          96, 128)]
    cases = (
        ("flow step (96x128, batch 2, 8 iterations)", "epe", pair,
         lambda m, b: T.flow_loss(m, *b, iters=8), (1e-5, 1e-5, 1e-5),
         lambda n: 2e-3),
        ("DBA step (96x128, N=7, 4 rounds, one scene)", "ate", seq,
         lambda m, b: T.dba_scene_loss(m, *b, N=7, iters=4),
         (1e-3, 1e-3, 5e-3),
         lambda n: 2e-2 if n.startswith("update.") else 2e-1))
    for label, metric, batch, fn, rel_tol, tol in cases:
        t0 = time.perf_counter()
        ref = _loss_and_grads(cpu, lambda m: fn(m, batch))
        cpu_s = time.perf_counter() - t0
        wit = _loss_and_grads(witness, lambda m: fn(m, batch))
        on_card = [t.to(dev) for t in batch]
        got = _loss_and_grads(card, lambda m: fn(m, on_card))
        rel = [abs(a - b) / abs(b) for a, b in zip(got[:3], ref[:3])]
        gmax = max(float(g.abs().max()) for g in ref[3].values())
        worst = {"update": (0.0, "", 0.0), "encoders": (0.0, "", 0.0)}
        n_wide = 0
        for n, g in ref[3].items():
            if _zero_by_norm(n):
                if max(float(g.abs().max()), float(got[3][n].abs().max())) \
                        > 1e-6 * gmax:
                    raise SystemExit(f"trainer parity: {n} has a gradient "
                                     "where InstanceNorm makes it zero")
                continue
            scale = float(g.abs().max())
            if scale == 0:
                if float(got[3][n].abs().max()) != 0:
                    raise SystemExit(f"trainer parity: {n}: a gradient on "
                                     "the card only")
                continue
            gap = float((got[3][n] - g).abs().max()) / scale
            floor = float((wit[3][n] - g).abs().max()) / scale
            n_wide += floor > 1e-2
            if gap > max(tol(n), 3 * floor):
                raise SystemExit(f"trainer parity: {label}: {n} differs by "
                                 f"{gap:.2e} of its max, above "
                                 f"{max(tol(n), 3 * floor):.2e} (witness "
                                 f"{floor:.2e})")
            part = "update" if n.startswith("update.") else "encoders"
            worst[part] = max(worst[part], (gap, n, floor))
        wit_rel = [abs(a - b) / abs(b) for a, b in zip(wit[:3], ref[:3])]
        log(f"trainer parity: {label}: card against CPU ({cpu_s:.1f} s on "
            f"the CPU): loss {got[0]:.7g} vs {ref[0]:.7g} (rel "
            f"{rel[0]:.2e}), {metric} {got[1]:.7g} vs {ref[1]:.7g} (rel "
            f"{rel[1]:.2e}), gnorm {got[2]:.7g} vs {ref[2]:.7g} (rel "
            f"{rel[2]:.2e}); witness rel " + ", ".join(
                f"{x:.2e}" for x in wit_rel) + "; worst gradient gap " +
            "; ".join(f"{k} {v[0]:.2e} of its max ({v[1]}, witness "
                      f"{v[2]:.2e})" for k, v in worst.items()) +
            f"; {n_wide} tensors move by more than 1e-2 of their max under "
            "the witness")
        for name, r, t in zip(("loss", metric, "gnorm"), rel, rel_tol):
            if r > t:
                raise SystemExit(f"trainer parity: {label}: {name} differs "
                                 f"by {r:.2e} relative, above {t}")


def _per_bucket(records, label):
    """ms per step per image shape: the median after each shape's first two
    steps (the first ones pay cuDNN's algorithm search and the
    allocator's growth)."""
    by = {}
    for r in records["steps"]:
        by.setdefault(r["shape"], []).append(r["ms"])
    out = {}
    for shape, ms in sorted(by.items()):
        rest = sorted(ms[2:]) or sorted(ms)
        out[f"{shape[0]}x{shape[1]}"] = rest[len(rest) // 2]
        log(f"{label}: {shape[0]}x{shape[1]}: {len(ms)} steps, "
            f"{rest[len(rest) // 2]:.1f} ms per step (median of "
            f"{len(rest)}), all: " + ", ".join(f"{x:.1f}" for x in ms))
    return out


def trainer_phase(dev):
    """Phase 13 (see the module docstring)."""
    import tempfile
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from splatslam_tpu_torch.models.weights import (init_params,
                                                    load_droid_params,
                                                    load_selftrained)
    from splatslam_tpu_torch.train import droid_trainer as T

    t_phase = time.perf_counter()
    trainer_parity(dev)

    _, hist = T.train(steps=8, batch=2, H=64, W=96, lr=4e-4, ckpt_path=None,
                      log_every=4, pool=1, device=dev)
    log(f"trainer descent: EPE {hist}")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise SystemExit(f"trainer descent: EPE did not fall: {hist}")

    with tempfile.TemporaryDirectory() as tmp:
        flow_ckpt = os.path.join(tmp, "droid_selftrained.msgpack")
        dba_ckpt = os.path.join(tmp, "droid_dba.msgpack")
        rec = {}
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        T.train(steps=12, batch=4, lr=2e-4, buckets=T.FLOW_BUCKETS, iters=8,
                pool=4, ckpt_path=flow_ckpt, log_every=1, device=dev,
                records=rec)
        flow_ms = _per_bucket(rec, "flow stage")
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        hist = [(r["loss"], r["epe"]) for r in rec["steps"]]
        log(f"flow stage: pool render {rec['pool_render_s']:.2f} s (host, "
            f"4 batches), peak {peak:.2f} GiB above the "
            f"{held / 2 ** 30:.2f} GiB held before; loss/EPE "
            + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in hist))
        if not np.isfinite(hist).all():
            raise SystemExit("flow stage: a loss or EPE is not finite")

        start = load_selftrained(flow_ckpt, device=dev)
        heads = ("update.weight.2.weight", "update.agg.eta.0.weight")
        before = {n: p.detach().clone() for n, p in start.named_parameters()
                  if n in heads}
        rec = {}
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model, _ = T.train_dba(steps=8, batch=2, N=7, iters=8, lr=5e-5,
                               buckets=T.FLOW_BUCKETS, pool=4,
                               init_ckpt=flow_ckpt, ckpt_path=dba_ckpt,
                               log_every=1, device=dev, records=rec)
        dba_ms = _per_bucket(rec, "DBA stage")
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        hist = [(r["loss"], r["ate"], r["gnorm"]) for r in rec["steps"]]
        log(f"DBA stage: pool render {rec['pool_render_s']:.2f} s (host, "
            f"4 batches), peak {peak:.2f} GiB above the "
            f"{held / 2 ** 30:.2f} GiB held before; loss/ATE/gnorm "
            + ", ".join(f"{a:.4f}/{b:.4f}/{c:.2f}" for a, b, c in hist))
        if not np.isfinite(hist).all() or min(h[2] for h in hist) <= 0:
            raise SystemExit("DBA stage: a loss, ATE or gnorm is not finite "
                             "and positive")
        params = dict(model.named_parameters())
        for n in heads:
            moved = float((params[n].detach() - before[n]).abs().max())
            log(f"DBA stage: {n} moved by up to {moved:.3e}")
            if not moved > 0:
                raise SystemExit(f"DBA stage: {n} did not move")

        back = load_droid_params(dba_ckpt, device=dev, dtype=torch.float32)
        for (n, a), b in zip(model.state_dict().items(),
                             back.state_dict().values()):
            if not torch.equal(a, b):
                raise SystemExit(f"checkpoint: {n} read back differently")
        net16 = load_droid_params(dba_ckpt, device=dev, dtype=torch.bfloat16)
        g = torch.Generator(device="cpu").manual_seed(1)
        x = [torch.randn((22, c, 30, 40), generator=g).to(dev)
             for c in (128, 128, 196, 4)]
        with torch.no_grad():
            res = net16.update_step(*x)
        if not all(bool(torch.isfinite(t).all()) for t in res):
            raise SystemExit("checkpoint: the bf16 net gave a non-finite "
                             "update")
        log(f"checkpoint: {os.path.getsize(dba_ckpt)} bytes, read back "
            "bit-identical in float32; bf16 update_step on 22 edges at "
            "30x40 finite")

    # (f) profile and FLOPs of one step of each stage at the large bucket
    H, W, fx = T.FLOW_BUCKETS[-1]
    big = f"{H}x{W}"
    model = init_params(torch.Generator().manual_seed(0), device=dev)
    opt = T.make_optimizer(model, 2e-4, 100)
    pair = [t.to(dev) for t in T.make_pair_batch(np.random.RandomState(0), 4,
                                                 H, W, fx)]
    seq = [t.to(dev) for t in T.make_seq_batch(np.random.RandomState(0), 2,
                                               7, H, W, fx)]
    steps = (("flow", T.make_train_step(model, opt, iters=8), pair,
              flow_ms[big]),
             ("DBA", T.make_dba_train_step(model, opt, N=7, iters=8), seq,
              dba_ms[big]))
    for name, step, batch, ms in steps:
        def run():
            step(*batch)
            torch.cuda.synchronize()
        with FlopCounterMode(display=False) as fc:     # also the warm-up
            run()
        flops = fc.get_total_flops()
        prof = profile_run(f"one {name} step at {big}", run, warmup=False)
        log(f"{name} step at {big}: {flops / 1e12:.3f} TFLOP (forward, "
            f"recompute and backward), {flops / ms / 1e9:.2f} TFLOP/s at "
            f"the stage's {ms:.1f} ms per step, device busy "
            f"{100 * prof['busy_share']:.1f}%, {prof['launches']} launches")
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase")
    ap.add_argument("--learned-only", action="store_true",
                    help="only the build, the learned path and the network "
                    "phase")
    ap.add_argument("--prior-only", action="store_true",
                    help="only the build, the prior path, the DPT and mesh "
                    "phases and the recorded-sequence path")
    ap.add_argument("--train-only", action="store_true",
                    help="only the build and the trainer phase")
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

    hashes = pretrained_hashes()
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
    def check_pretrained():
        if pretrained_hashes() != hashes:
            raise SystemExit("a file under pretrained/ changed")
        log(f"pretrained/: {len(hashes)} files unchanged")

    if args.train_only:
        trainer_phase(dev)
        check_pretrained()
        refuse_jax()
        return 0
    if args.learned_only:
        _, learned, _ = learned_path(dev)
        kernel_phase("learned final window", *window_input(learned))
        network_phase(learned, dev)
        refuse_jax()
        return 0
    if args.prior_only:
        _, prior = prior_path(dev, None)
        kernel_phase("prior final window", *window_input(prior))
        dpt_phase(prior, dev)
        mesh_phase(prior, dev)
        recorded_path(prior, dev)
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
    counts_learned, learned, learned_res = learned_path(dev)
    window_learned = kernel_phase("learned final window",
                                  *window_input(learned))
    network_phase(learned, dev)
    del learned
    torch.cuda.empty_cache()
    counts_prior, prior = prior_path(dev, learned_res)
    window_prior = kernel_phase("prior final window", *window_input(prior))
    dpt_phase(prior, dev)
    mesh_phase(prior, dev)
    counts_recorded = recorded_path(prior, dev)
    del prior
    torch.cuda.empty_cache()
    trainer_phase(dev)
    check_pretrained()
    src = "splatslam_tpu_torch/csrc/composite.cu"
    replaces = {"composite_fwd": "splatslam_tpu/ops/raster_pallas.py:333",
                "composite_bwd": "splatslam_tpu/ops/raster_pallas.py:387"}
    kernels = []
    for name, m in cloud.items():
        w = window[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=counts[name], launches_learned=counts_learned[name],
            launches_prior=counts_prior[name],
            launches_recorded=counts_recorded[name], **m,
            one_camera={k: v for k, v in single[name].items()
                        if k != "library_ms"},
            window={k: v for k, v in w.items() if k != "library_ms"},
            learned_window={k: v for k, v in window_learned[name].items()
                            if k != "library_ms"},
            prior_window={k: v for k, v in window_prior[name].items()
                          if k != "library_ms"}))
    refuse_jax()
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
