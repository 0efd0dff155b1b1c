"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                  # kernels + the main path (one card)
    python3 chip_smoke.py --kernels-only   # phases 1-3 only
    python3 chip_smoke.py --learned-only   # phases 1-2 and 7-8 only
    python3 chip_smoke.py --prior-only     # phases 1-2 and 9-12 only
    python3 chip_smoke.py --train-only     # phases 1-2 and 13 only
    python3 chip_smoke.py --last-only      # phases 1-2 and 14-17 only
    python3 chip_smoke.py --multidevice-only  # phases 1-2 and 14 only (on
        # a machine with several cards, phase 14 also splits over them)
    python3 chip_smoke.py --profilers-only # phases 1-2 and 18 only
    python3 chip_smoke.py --bench-only     # phases 1-2 and 19 only
    python3 chip_smoke.py --judge-only CKPT [--judge-ref REF]  # phases 1-2,
        # then the tools and smoke.yaml on REF (default the shipped
        # pretrained/droid_dba.msgpack) and on CKPT side by side
    python3 chip_smoke.py --dba-eval CKPT [CKPT ...]  # phases 1-2, then
        # each checkpoint through the DBA stage's loss with no update
    python3 chip_smoke.py --train-cli "ARGS"  # phases 1-2, then
        # `python -m splatslam_tpu_torch.train_droid ARGS` in this process,
        # timed step by step
    python3 chip_smoke.py --kernels-only "--time-flags= |-fmad=true"
        # also time the kernels built with other nvcc flags (here: the
        # port's own and -fmad=true) and report how far their results move
    python3 chip_smoke.py --kernels-only --sweep-pixels-per-thread
        # also time each kernel at every number of pixels per thread it is
        # built for, on 1 to 10 cameras of the kernel-phase input: what
        # raster_cuda.pixels_per_thread's thresholds rest on

Phases, each unguarded (any failure exits non-zero). Before each phase both
TF32 switches (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32) are
turned on, and after it both must be off: each phase shows that the port's
entry point it goes through (resolve_device) switched them off; a phase on
objects an earlier phase built resolves its device itself, and a phase that
runs the port in a child process has the child hold the same check:
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA source under splatslam_tpu_torch/csrc/ (one nvcc
     per source, all started together);
  3. kernel phase: B1/B2 (3DGS tile compositor forward/backward) on a real
     input at replica_scale shapes (10 cameras, 320x640, K=256, capacity
     131072), binned from a seeded Gaussian cloud by the port's bin_batch,
     held against their plain PyTorch versions on the card, then timed
     with CUDA events (warm-up, median of 10), B1 with and without
     n_touched; then the same on one camera of that input, the grid of most
     of the main path's launches; then DSPO stage 2's kernels (csrc/dspo.cu:
     the iteration and the multiview filter) at the cells' shapes against
     their plain versions, and timed beside them (dspo_phase);
  4. main path: configs/Synthetic/replica_scale.yaml through the port's
     SLAM at full width and full depth, with every kernel launch count
     reset just before and read just after (each must be non-zero);
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
         FlopCounterMode; then at 240x320 (under --train-only at both
         buckets; batch 2, N=7, 8 rounds) the DBA step (one forward over
         the batch, one backward) beside the per-scene loop the port ran
         before it (each scene's loss back-propagated on its own): ms per
         step (median of 3), launches, busy share, peak memory;
     every file under pretrained/ hashes the same before and after the
     script;
 14. multi-device phase (camera-parallel mapping, run right after phase 6
     on phase 4's final window): one map_step_n segment of that window (9
     cameras, 320x640, capacity 131072, K 256) over ["cuda:0"] * 2 and
     ["cuda:0"] * 3 (and over cuda:0-1 and cuda:0-2 where that many cards
     are visible) against one device, batched (5 iterations) and one
     camera per step, each shard with its own replica of the map; gates:
     loss rtol 1e-5; for xyz and opacity the elements outside the JAX
     suite's mesh tolerances (atol 1e-5, rtol 1e-4), for n_touched the
     unequal ones, no more than 4x what two more one-device runs differ
     from the first by, plus 64 (B2's float atomics: one device does not
     reproduce itself on the card, and the shards' other summation order
     about doubles the count; the CPU tests hold the exact tolerances);
     B1/B2 launched once per shard and iteration, no plain compositor
     call; the gate must reject two faults planted over ["cuda:0"] * 2 (a
     double Adam step, replicas never refreshed: each moves tens of
     thousands of elements); B1/B2 against their plain versions on one
     shard's rows; then smoke_oracle.yaml, uncut, with
     mapping.mesh_devices 2: on one card the mapper falls back with JAX's
     message (on several it splits over two), and the run passes the
     oracle gate (kf-ATE <= 0.01);
 15. loop phase: tests/test_loop_closure.py's pendulum configuration (100
     frames, 96x128, loop_period 48, tracking only, final BA off) with loop
     closure on and off: loop_ba calls, edges per call and kf-ATE of both
     arms; gates: a loop_ba call built edges, the loop arm's kf-ATE is
     finite and at most 0.25; and the learned path's loop_ba calls;
 16. trace phase: `python -m splatslam_tpu_torch.run` on smoke_oracle.yaml
     cut to 12 frames, without and with `--profile DIR`: gates: the trace
     exists and names composite_fwd, composite_bwd and the loop's phases;
     its size and the run's wall both ways; and the gate that the learned
     path called on_frame once per frame (every SLAM path of this script
     records the hook and is held to it);
 17. tools phase: the port's flow probe and admission calibration on
     pretrained/droid_dba.msgpack at 240x320 and the ate_matrix `base`
     arm, every printed line; gate: the card's gap-1 EPE within 1e-3
     relative of a CPU float32 run;
 18. profilers phase: the port's three per-layer profilers through their
     entry points at the JAX tools' default shapes, on the card, each
     printing its JSON line of per-layer milliseconds (CUDA events after
     warm-up), with every launch count reset just before and read just
     after: `kernel_bench`, `tracking_profile`, `map_step_profile` and
     `map_step_profile --ssim --dense`; gates: every row finite and > 0,
     both kernels launched; then B1/B2 against their plain versions on the
     profiler's own cloud (12 cameras at 320x640, K 256), and on its dense
     cloud (mean 1131 contributors a tile, 4x K, where the kernel's float
     atomics and the plain version's index_add sum B2's gradients in other
     orders and part of them nearly cancel: they differed by 1.5e-3 against
     |grad| up to 8.4e3 in one run, 1.2e-3 in the next), where an output
     outside the tolerances is refereed: held against a float64 run of the
     plain version, the kernel's max error at most twice the float32 plain
     version's plus the unchanged atol.
     The main path (phase 4) and every SLAM path also print the run's
     achieved-FLOP counters (`flops_tracking`, `flops_mapping`) and their
     sum over the run's wall;
 19. bench phase: `python -m splatslam_tpu_torch.bench` (the port's
     bench.py: its modes and lines) as a subprocess over its four
     modes, cut to 24 measured frames, a 6-frame prime and 32 refinement
     iterations (BENCH_CUT), on the kernels phase 2 built; gates: exit 0,
     every stdout line JSON, a final line for each mode without `error`,
     kf-ATE <= 0.01 (oracle) and <= 0.25 (learned), achieved_tflops > 0,
     0 < mfu < 1.05, prime_ok, the probe names this card, the oracle final
     last, and both kernels launched and no plain compositor in each
     mode's measured run (the bench's `launches` events); then a short run
     cut by SIGTERM must print the partial line, then the last final, and
     exit 0. Its lines are kept in bench.out and bench.err beside the
     paths' outputs;
 20. the kernels JSON line, then the device JSON line last.

`--judge-only CKPT` (a tracker checkpoint, e.g. one train_droid wrote) runs
the build, then for the reference (`--judge-ref REF`, default
pretrained/droid_dba.msgpack; give the shipped
pretrained/droid_selftrained.msgpack to judge a flow-stage file) and for
CKPT in turn: the flow probe (EPE and first_delta by gap), the admission
calibration (admitted/60 at each threshold), the ate_matrix `base` arm
(SPLATSLAM_CKPT) and one uncut smoke.yaml run with tracking.pretrained set
to the checkpoint (kf-ATE, full ATE, PSNR, keyframes), one line per tool
and checkpoint. Gates: every number finite for both; the reference's
smoke kf-ATE within 0.25 (the JAX suite's learned-tracker bound); CKPT's
is printed beside that bound.

`--dba-eval CKPT [CKPT ...]` runs the build, then at each of the trainer's
buckets renders 32 batches of 2 sequences (make_seq_batch, seed 0, N=7)
once and puts each checkpoint through the DBA stage's loss on them with
no update (dba_batch_loss, 8 rounds, float32, no gradient): one line per
checkpoint and bucket with the mean and median over the batches of the
loss and of the ATE, the metric the trainers log (the JAX trainer logged
0.005-0.007 m for the shipped file and 0.0044 m for the round-5 one at
240x320 while training them). Gate: every number finite.

`--train-cli "ARGS"` runs train_droid's main() on ARGS in this process
(what `python -m splatslam_tpu_torch.train_droid ARGS` runs), with each
stage's steps recorded: wall, ms per step per bucket, the wait for host
batches, peak memory, FLOPs of one step per bucket (FlopCounterMode) and
TFLOP/s, the SHA-256 of each file written; the per-step records go to
chiprun_out/train/<stage>_records.json. Give it --out/--dba-out outside
pretrained/ (whose hashes it checks).

The machine this script is written for has numpy, scipy, cv2 and PIL and no
matplotlib: every path runs with `eval_plots` off (panels and trajectory
figures are drawn on a machine that has matplotlib, see the README), and
phase 12 needs cv2.

`--learned-only` skips phases 3-6 and 9-17, `--prior-only` phases 3-8 and
13-17, `--train-only` phases 3-12 and 14-17, `--last-only` phases 3 and 5-13
but runs phase 4 (the input of phase 14) and phase 7's learned path (whose
hook and loop_ba calls phases 15 and 16 read) without their kernel checks,
`--multidevice-only` runs phase 4 and phase 14, `--profilers-only` phase 18,
`--bench-only` phase 19 (none of them prints the kernels line).

Exits non-zero without printing a result when no CUDA device is present,
or when the port's package is not beside this script.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import signal
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


def tf32_flags():
    import torch
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def phase(label, fn, *args, in_child=False, **kw):
    """Run one phase with both TF32 switches turned on first; they must be
    off when it ends (its entry into the port switched them off). With
    `in_child` the phase runs the port in a child process that holds the
    same check itself (TF32_CHILD)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    out = fn(*args, **kw)
    if not in_child and any(tf32_flags()):
        raise SystemExit(f"{label}: TF32 still on after the phase (matmul, "
                         f"cudnn) = {tf32_flags()}: its entry point did "
                         "not switch it off")
    log(f"TF32 check: {label}: on before, "
        + ("checked in the child" if in_child else "off after"))
    return out


# `python -c TF32_CHILD MODULE ARGS...` is `python -m MODULE ARGS...` with
# both TF32 switches on at the start; when the module ends they must be
# off (its entry point switched them), else the child exits 3
TF32_CHILD = """import runpy, sys, torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
    code = 0
except SystemExit as e:
    code = e.code
on = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
if any(on):
    print(f"{mod} ended with TF32 on: {on}", file=sys.stderr)
    sys.exit(3)
sys.exit(code)
"""


def flops_line(label, video, wall):
    """The run's achieved-FLOP counters (host arithmetic of the JAX
    package's FLOP model, DepthVideo's docstring) and their sum over the
    run's wall."""
    ft, fm = video.flops_tracking, video.flops_mapping
    log(f"{label}: flops_tracking {ft:.6e} flops_mapping {fm:.6e} wall "
        f"{wall:.3f} s achieved_tflops {(ft + fm) / wall / 1e12:.6f} "
        f"(card: {card_line()})")


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
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.ops import lie, rasterizer as R
    dev = resolve_device(dev)
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


def refereed(name, got, plain, exact, atol):
    """A kernel's output and its float32 plain version's against a float64
    run of the plain version: the kernel may be off by at most twice what
    the float32 plain version is, plus `atol`."""
    e_k = (got.double() - exact).abs().max().item()
    e_p = (plain.double() - exact).abs().max().item()
    ok = e_k <= 2 * e_p + atol
    log(f"{name} against a float64 run of the plain version: kernel "
        f"max|err| {e_k:.3e}, float32 plain {e_p:.3e} (gate: kernel <= 2x "
        f"plain + {atol:g}) {ok}")
    return ok


def kernel_phase(label, packets, tile_ids, counts, ntx, time_flags=None,
                 referee=False):
    """B1/B2 on one input: held against their plain versions, then timed.
    With `referee`, an output outside the elementwise tolerances is held
    against a float64 run of the plain version instead (refereed). Returns
    the measurements by kernel name."""
    import torch
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R
    dev = resolve_device(packets.device)
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
    ok_1 = err_cd <= 1e-5 and err_a <= 1e-4
    if not ok_1 and referee:
        out64, _ = R.composite_fwd_torch(packets.double(), tile_ids, counts,
                                         ntx, want_touched=False)
        ok_1 = all([refereed("B1 colour/depth", out_k[:, :, :4],
                             out_p[:, :, :4], out64[:, :, :4], 1e-5),
                    refereed("B1 alpha", out_k[:, :, 4], out_p[:, :, 4],
                             out64[:, :, 4], 1e-4)])
    if not (ok_1 and nt_eq and no_touch_ok):
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
    if not ok_g and referee:
        ok_g = refereed("B2", gr_k, gr_p, R.composite_bwd_torch(
            packets.double(), tile_ids, counts, ntx, gout.double(),
            out_k.double()), 1e-4)
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


def dspo_phase(dev):
    """DSPO stage 2's kernels (csrc/dspo.cu) at the cells' shapes
    (tests/dspo_cases.py): an iteration on replica_scale's round (40x80,
    E 100, M 40, buffer 400) and on a learned-shaped loop-closure round
    (48x64, E 169, M 28, buffer 600), the filter on a round's frames at 1/8
    resolution and on 5 frames at 320x640. Each is held against its plain
    version on the card as tests/test_torch_cuda.py holds it (an iteration
    within twice the float32 plain version's distance from a float64 run,
    plus 1e-6; the filter's counts equal), then timed by CUDA events beside
    the plain version and its bound. Returns the measurements."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from dspo_cases import make_filter_problem, make_problem
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.ops import ba, dspo_cuda
    from splatslam_tpu_torch.tracking import depth_video as dv
    dev = resolve_device(dev)
    keys = ("poses", "disps", "intrinsics", "target", "weight", "eta",
            "mono_disps", "scales", "shifts", "valid_depth_mask")

    def on(p, dtype=torch.float32):
        e = p["edges"]
        args = [p[k].to(dev) if p[k].dtype == torch.bool
                else p[k].to(dev, dtype) for k in keys]
        mask = None if p["kx_mask"] is None else p["kx_mask"].to(dev)
        return (*args, ba.make_edges(e.ii, e.jj, e.t0, e.t1, dev), p["lm"],
                p["ep"], p["alpha"], mask)

    out = {}
    for label, name, buffer in (("replica round", "replica", 400),
                                ("loop round", "loop", 600)):
        args = on(make_problem(name, buffer=buffer))
        got = ba._scale_shift_iteration(*args)
        plain = ba._scale_shift_iteration_torch(*args)
        exact = ba._scale_shift_iteration_torch(
            *on(make_problem(name, buffer=buffer), torch.float64))
        errs = [(float((g.double() - x).abs().max()),
                 float((q.double() - x).abs().max()))
                for g, q, x in zip(got, plain, exact)]
        ok = all(e_k <= 2 * e_p + 1e-6 for e_k, e_p in errs)
        log(f"DSPO iteration, {label}: |kernel - f64| / |plain - f64| "
            "(disps, scales, shifts) " + ", ".join(
                f"{e_k:.3e} / {e_p:.3e}" for e_k, e_p in errs) + f" {ok}")
        if not ok:
            raise SystemExit(f"the DSPO iteration disagrees with its plain "
                             f"version ({label})")
        edges = args[10]
        B, h, w = args[1].shape
        ms = cuda_ms(lambda: ba._scale_shift_iteration(*args))
        ms_p = cuda_ms(lambda: ba._scale_shift_iteration_torch(*args))
        bound, by = dspo_cuda.kernel_bounds(
            len(edges.ii), edges.M, B, h * w)["scale_shift_iteration"]
        log(f"DSPO iteration, {label} (E {len(edges.ii)}, M {edges.M}, "
            f"{h}x{w}, buffer {B}): kernel {ms:.4f} ms, plain {ms_p:.3f} ms, "
            f"bound {bound:.4f} ms by {by}")
        out[label] = dict(max_abs_err=max(float((g - q).abs().max())
                                          for g, q in zip(got, plain)),
                          ms=ms, plain_ms=ms_p, bound_ms=bound, bound_by=by)
    for label, name in (("filter 1/8", "eighth"), ("filter full", "full")):
        f = {k: v.to(dev) for k, v in make_filter_problem(name).items()}
        args = (f["poses"], f["disps"], f["intrinsics"], f["inds"],
                f["thresh"])
        got = dv.depth_filter(*args)
        plain = dv.depth_filter_torch(*args)
        n_diff = int((got != plain).sum())
        log(f"depth filter, {label}: {n_diff} of {got.numel()} counts "
            "differ from the plain version's")
        if n_diff:
            raise SystemExit(f"the depth filter disagrees with its plain "
                             f"version ({label})")
        num, h, w = f["disps"].shape
        nb = f["inds"][:, None] + torch.tensor([0, -1, -2, -3, 3, 4, 5],
                                               device=dev)
        rows = int(torch.unique(nb[(nb >= 0) & (nb < num)]).numel())
        ms = cuda_ms(lambda: dv.depth_filter(*args))
        ms_p = cuda_ms(lambda: dv.depth_filter_torch(*args))
        bound, by = dspo_cuda.kernel_bounds(
            0, 0, 0, h * w, len(f["inds"]), rows)["depth_filter"]
        log(f"depth filter, {label} ({len(f['inds'])} frames of {h}x{w}): "
            f"kernel {ms:.4f} ms, plain {ms_p:.3f} ms, bound {bound:.4f} ms "
            f"by {by}")
        out[label] = dict(max_abs_err=0.0, ms=ms, plain_ms=ms_p,
                          bound_ms=bound, bound_by=by)
    return out


def window_input(slam, rows=slice(None)):
    """Packets and tile lists of the main path's final keyframe window (its
    `rows`), as map_step_n's loop makes them: (packets, tile_ids, counts,
    ntx)."""
    import torch
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.mapping import gaussians as G, mapper as M
    from splatslam_tpu_torch.ops import rasterizer as R
    resolve_device(slam.device)
    mp = slam.mapper
    st = mp.st
    with torch.no_grad():
        w2cs = mp._stack_cams([mp.viewpoints[k]
                               for k in mp.current_window])[0][rows]
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
    from splatslam_tpu_torch.ops import dspo_cuda, raster_cuda, rasterizer as R

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
    dspo_cuda.reset_launch_counts()
    for k in R.plain_calls:
        R.plain_calls[k] = 0
    t0 = time.perf_counter()
    slam = slam_mod.SLAM(cfg, device=dev)
    res = slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(raster_cuda.launches) | dict(dspo_cuda.launches)
    plain = dict(R.plain_calls)
    log(f"main path: frames {res['n_frames']} keyframes {res['n_keyframes']} "
        f"mapped {len(slam.mapper.viewpoints)} wall {wall:.1f} s fps "
        f"{res['n_frames'] / wall:.3f}")
    flops_line("main path", slam.video, wall)
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
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.mapping import mapper as M
    resolve_device(slam.device)
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


def spy_loop_ba(edges):
    """Backend.loop_ba, recording each call's edge count into `edges`;
    returns the original to put back."""
    from splatslam_tpu_torch.tracking import backend as BK
    orig = BK.Backend.loop_ba

    def spy(self, *a, **kw):
        win, n_edges = orig(self, *a, **kw)
        edges.append(n_edges)
        return win, n_edges

    BK.Backend.loop_ba = spy
    return orig


def run_slam(label, cfg, dev):
    """One SLAM run with every launch count reset just before and read just
    after: (launch counts, SLAM object, results). The results also hold the
    run's on_frame calls ("frames") and the edge count of each loop_ba call
    ("loop_edges"). Fails on a non-finite result, a kernel that never
    launched, a plain compositor call or an on_frame hook not called once
    per frame in order."""
    import torch
    from splatslam_tpu_torch import slam as slam_mod
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R
    from splatslam_tpu_torch.tracking import backend as BK
    frames, loop_edges = [], []
    raster_cuda.reset_launch_counts()
    for k in R.plain_calls:
        R.plain_calls[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slam = slam_mod.SLAM(cfg, device=dev)
    orig = spy_loop_ba(loop_edges)
    try:
        res = slam.run(on_frame=lambda i, ts, kf: frames.append((i, ts, kf)))
    finally:
        BK.Backend.loop_ba = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(raster_cuda.launches)
    plain = dict(R.plain_calls)
    res.update(frames=frames, loop_edges=loop_edges)
    log(f"{label}: weights {res['weights']} frames {res['n_frames']} "
        f"keyframes {res['n_keyframes']} mapped "
        f"{len(slam.mapper.viewpoints)} wall {wall:.1f} s fps "
        f"{res['n_frames'] / wall:.3f}")
    flops_line(label, slam.video, wall)
    log(f"{label} phase timers (s): " + json.dumps(res["timers"]))
    log(f"{label}: kf-ATE {res['ate_rmse']} full ATE {res['full_ate_rmse']} "
        f"PSNR {res['psnr']} SSIM {res['ssim']} depth-L1 {res['depth_l1']} "
        f"proxy depth-L1 {res['proxy_depth_l1']} mesh {res['mesh']}")
    log(f"launches on the {label}: {counts}; plain compositing calls "
        f"{plain}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{label}: on_frame called {len(frames)} times (last "
        f"{frames[-1] if frames else None}); fe.loop_ba calls "
        f"{slam.timers.count.get('fe.loop_ba', 0)}, loop_ba edges "
        f"{loop_edges}")
    if [f[0] for f in frames] != list(range(res["n_frames"])):
        raise SystemExit(f"{label}: on_frame was not called once per frame")
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


def smoke_cfg(out_name, path="configs/Synthetic/smoke.yaml"):
    from splatslam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, path),
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
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.datasets import get_dataset
    from splatslam_tpu_torch.models.dpt import DPTDepthPredictor
    resolve_device(dev)     # the prior path's predictor: no TF32
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
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.utils.eval_render import (fuse_keyframes,
                                                       _render_depth)
    from splatslam_tpu_torch.utils.mesh import clean_mesh
    resolve_device(dev)     # the prior path's map: no TF32
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
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.datasets import TUM_RGBD
    resolve_device(dev)     # prior.mono below runs the DPT before SLAM
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
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.models.droid_net import normalize_images
    from splatslam_tpu_torch.models.weights import load_droid_params
    from splatslam_tpu_torch.ops import corr as corr_ops
    from splatslam_tpu_torch.tracking import factor_graph as FG
    from splatslam_tpu_torch.tracking.depth_video import reproject
    resolve_device(dev)     # the learned path's net: no TF32

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


def dba_step_forms(model, opt, dev, buckets, N=7, iters=8):
    """Phase 13 (f), second half: at each bucket, one batch of 2 scenes
    through the DBA step (make_dba_train_step: one forward over the batch,
    one backward) and through the per-scene loop the port ran before it
    (each scene's dba_scene_loss back-propagated on its own, divided by
    the batch, then the same optimizer step): ms per step (CUDA-
    synchronised, median of 3 after a warm-up), launches and device busy
    time of one step (torch.profiler), peak memory above what was held."""
    import numpy as np
    import torch
    from splatslam_tpu_torch.train import droid_trainer as T

    def per_scene(imgs, disps_gt, poses_gt, intr8):
        opt.zero_grad()
        B = imgs.shape[0]
        for b in range(B):
            loss, _ = T.dba_scene_loss(model, imgs[b], disps_gt[b],
                                       poses_gt[b], intr8[b], N, iters)
            (loss / B).backward()
        opt.step()

    forms = (("batched", T.make_dba_train_step(model, opt, N=N, iters=iters)),
             ("per-scene loop", per_scene))
    for H, W, fx in buckets:
        seq = [t.to(dev) for t in T.make_seq_batch(np.random.RandomState(0),
                                                   2, N, H, W, fx)]
        got = {}
        for form, step in forms:
            def run():
                step(*seq)
                torch.cuda.synchronize()
            run()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
            ms = sorted(times)[1]
            prof = profile_run(f"one DBA step ({form}) at {H}x{W}", run,
                               warmup=False)
            got[form] = dict(ms=ms, peak=peak, **prof)
        ratio = got["batched"]["launches"] / got["per-scene loop"]["launches"]
        log(f"DBA step at {H}x{W}, batch 2, N={N}, {iters} rounds: "
            + "; ".join(
                f"{form} {g['ms']:.1f} ms per step (median of 3), "
                f"{g['launches']} launches, device busy {g['busy_ms']:.1f} "
                f"ms ({100 * g['busy_ms'] / g['ms']:.1f}% of the step), "
                f"peak {g['peak']:.2f} GiB" for form, g in got.items())
            + f"; launches batched / per-scene {ratio:.3f}")


def trainer_phase(dev, both_buckets=False):
    """Phase 13 (see the module docstring); the DBA step beside the
    per-scene loop at both buckets with `both_buckets` (--train-only), at
    240x320 otherwise (each profile of a DBA step costs half a minute)."""
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
    dba_step_forms(model, opt, dev, T.FLOW_BUCKETS if both_buckets
                   else T.FLOW_BUCKETS[-1:])
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phases 14-17: camera-parallel mapping, loop closure, trace and hook, tools
# ---------------------------------------------------------------------------

class _Tee:
    """Standard output that is also kept, to look for a printed line."""

    def __init__(self, out):
        import io
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def multidevice_segments(slam, iters=5):
    """One map_step_n segment on the main path's final window over
    ["cuda:0"] * 2 and ["cuda:0"] * 3 (and, where that many cards are
    visible, over cuda:0, cuda:1[, cuda:2]) against one device, per_step
    False and True, from the same map, run twice. Frozen (every learning
    rate 0, so the map and the poses stay put and B2's float atomics cannot
    compound over the iterations): parameters, poses, radii, n_touched,
    denom and max_radii2D equal to one device's, the loss within rtol 1e-5
    (the JAX mesh test's), the Adam moments, grad_accum and the exposure
    rows within 1e-2 in the L2 norm (on a converged map the per-camera
    gradients nearly cancel, so their sum in another order is not held
    elementwise; a second Adam step moves the moments by ~80%). Live (the
    mapper's learning rates, where one device does not reproduce itself):
    the loss within rtol 1e-5 of the range four one-device runs span.
    Both: B1/B2 launched once per shard and iteration and no plain
    compositor call. The gates must reject two planted faults over
    ["cuda:0"] * 2, a double Adam step and replicas never refreshed.
    Returns the kernels' launches over the sharded segments."""
    import contextlib
    import types
    import torch
    from splatslam_tpu_torch.mapping import gaussians as G, mapper as M
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R
    mp = slam.mapper
    st0 = mp.st
    cams = [mp.viewpoints[k] for k in mp.current_window]
    w2cs, imgs, deps, expo, use_exp, valid = mp._stack_cams(cams)
    B = len(cams)
    dev = w2cs.device
    pose_mask = (torch.arange(B, device=dev) > 0) & (
        torch.arange(B, device=dev) < mp.pose_window)
    op = mp.opt
    lr_sched = (op["position_lr_init"] * 6.0, op["position_lr_final"] * 6.0,
                op["position_lr_delay_mult"], op["position_lr_max_steps"])
    lrs = dict(xyz=0.0, f_dc=op["feature_lr"], f_rest=op["feature_lr"] / 20,
               opacity=op["opacity_lr"], scaling=op["scaling_lr"] * 6.0,
               rotation=op["rotation_lr"])
    cam_lrs = (0.5 * mp.lr_cam_trans, 0.5 * mp.lr_cam_rot)
    log(f"multi-device input: the main path's final window, {B} cameras "
        f"{mp.H}x{mp.W}, capacity {st0.capacity} "
        f"({int(st0.alive.sum())} alive), K {mp.K}; {iters} iterations "
        f"batched, {B} per step; poses optimised on rows 1..."
        f"{int(pose_mask.sum())}")

    def segment(devices, per_step, frozen):
        st = G.GaussianState(**{k: v.clone() for k, v in vars(st0).items()})
        z = lambda n: torch.zeros((B, n), device=dev)
        n = B if per_step else iters
        raster_cuda.reset_launch_counts()
        for k in R.plain_calls:
            R.plain_calls[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = M.map_step_n(
            st, (z(2), z(2)), (z(6), z(6)), w2cs, imgs, deps, expo, use_exp,
            valid, pose_mask, mp.intrinsics,
            dict.fromkeys(lrs, 0.0) if frozen else lrs,
            (0.0, 0.0) if frozen else cam_lrs,
            mp.iteration_count, n, 0.0 if per_step else 10.0, H=mp.H,
            W=mp.W, K=mp.K, use_ssim=mp.use_ssim, alpha=mp.alpha,
            lr_sched=None if frozen else lr_sched, opt_poses=True,
            sh_degree=mp.sh_degree, rebin_every=mp.rebin_every,
            max_span=mp.max_span, per_step_cams=per_step, devices=devices)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        return out, ms, dict(raster_cuda.launches), dict(R.plain_calls), n

    exact = G.PARAM_NAMES + ("denom", "max_radii2D", "w2cs", "radii",
                             "n_touched")

    def frozen_diff(a, b):
        """{quantity: (|a - b| / |b| in the L2 norm, max|a - b| / max|b|)}
        of two frozen segments' outputs."""
        st_a, st_b = a[0], b[0]
        pairs = {n: (getattr(st_a, n), getattr(st_b, n))
                 for n in G.PARAM_NAMES + ("denom", "max_radii2D",
                                           "grad_accum")}
        pairs.update({f"{p}_{n}": (getattr(st_a, f"{p}_{n}"),
                                   getattr(st_b, f"{p}_{n}"))
                      for n in G.PARAM_NAMES for p in "mv"})
        pairs.update(w2cs=(a[3], b[3]), exposure=(a[4], b[4]),
                     radii=(a[5], b[5]), n_touched=(a[6], b[6]),
                     em=(a[1][0], b[1][0]), ev=(a[1][1], b[1][1]),
                     tm=(a[2][0], b[2][0]), tv=(a[2][1], b[2][1]),
                     loss=(a[-1], b[-1]))
        l2 = torch.linalg.vector_norm
        mx = lambda t: t.abs().max()
        rel = lambda x, y, norm: (norm(x.double() - y.double())
                                  / norm(y.double()).clamp(min=1e-30)).item()
        return {k: (rel(x, y, l2), rel(x, y, mx))
                for k, (x, y) in pairs.items() if y.numel()}

    def frozen_ok(d):
        return all(d[k][1] == 0 for k in exact if k in d) and \
            d["loss"][0] <= 1e-5 and all(v[0] <= 1e-2 for k, v in d.items()
                                         if k not in exact and k != "loss")

    def frozen_fmt(d):
        worst = max((k for k in d if k not in exact and k != "loss"),
                    key=lambda k: d[k][0])
        bad = [k for k in exact if k in d and d[k][1] != 0]
        return (f"loss rel {d['loss'][0]:.2e} (tol 1e-5); exact quantities "
                f"unequal: {bad or 'none'}; largest L2-relative difference "
                f"{worst} {d[worst][0]:.2e} (tol 1e-2; its largest element "
                f"{d[worst][1]:.2e} of the field's largest value)")

    def live_rel(a, losses):
        """How far a live segment's loss lies outside the range of the
        one-device runs' losses, relative to it (0 inside)."""
        x, lo, hi = float(a[-1]), min(losses), max(losses)
        return max(lo - x, x - hi, 0.0) / abs(hi)

    def live_counts(a, b):
        """Elements of a live segment's output outside the JAX mesh
        tolerances against b (n_touched exact). Logged, not gated: B2's
        float atomics compound over a live segment, so one device does not
        reproduce them."""
        d = {}
        for name in ("xyz", "opacity"):
            x, y = getattr(a[0], name), getattr(b[0], name)
            d[name] = ((x - y).abs().max().item(), int((~torch.isclose(
                x, y, atol=1e-5, rtol=1e-4)).sum()))
        d["n_touched"] = ((a[6] - b[6]).abs().max().item(),
                          int((a[6] != b[6]).sum()))
        return ", ".join(f"{k} max|d| {m:.2e} outside {c}"
                         for k, (m, c) in d.items())

    lists = [(f"{n} entries of {dev}", [dev] * n) for n in (2, 3)]
    lists += [(f"cuda:0-{n - 1}", [torch.device("cuda", i) for i in range(n)])
              for n in (2, 3) if torch.cuda.device_count() >= n]

    @contextlib.contextmanager
    def planted(fault):
        """A fault the gates must reject: the map stepped by Adam twice per
        iteration (once per shard), or the replicas never refreshed."""
        if fault == "double Adam step":
            orig, name, mod = G.adam_step, "adam_step", G

            def fn(st, *a, **kw):
                orig(st, *a, **kw)
                return orig(st, *a, **kw)
        else:
            orig, name, mod = M._step_shards, "_step_shards", M

            def fn(st, reps, *a, **kw):
                return orig(st, [types.SimpleNamespace(**{
                    n: v.clone() for n, v in vars(r).items()})
                    for r in reps], *a, **kw)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, orig)

    total = {"composite_fwd": 0, "composite_bwd": 0}
    for per_step in (False, True):
        kind = "per_step" if per_step else "batched"
        one = {}
        for frozen in (True, False):
            mode = "frozen" if frozen else "live"
            runs = [segment(None, per_step, frozen)
                    for _ in range(2 if frozen else 4)]
            one[frozen], ms1, _, _, n = runs[0]
            if frozen:
                same = frozen_fmt(frozen_diff(runs[1][0], one[True]))
            else:
                losses = [float(r[0][-1]) for r in runs]
                same = (f"loss {min(losses):.7f}-{max(losses):.7f} over "
                        f"{len(runs)} runs (spread rel "
                        f"{(max(losses) - min(losses)) / max(losses):.2e}); "
                        f"second against first: "
                        f"{live_counts(runs[1][0], one[False])}")
            log(f"multi-device ({kind}, {mode}): one device "
                + " / ".join(f"{r[1]:.1f}" for r in runs)
                + f" ms per iteration; against itself: {same}")
            for label, devices in lists:
                out, ms, launches, plain, _ = segment(devices, per_step,
                                                      frozen)
                shards = 1 if per_step else min(len(devices), B)
                want = shards * n
                if frozen:
                    d = frozen_diff(out, one[frozen])
                    ok, got = frozen_ok(d), frozen_fmt(d)
                else:
                    rel = live_rel(out, losses)
                    ok = rel <= 1e-5
                    got = (f"loss {float(out[-1]):.7f}, outside one "
                           f"device's range by rel {rel:.2e} (tol 1e-5); "
                           f"against the first one-device run "
                           f"{live_counts(out, one[False])} (outside atol "
                           f"1e-5 / rtol 1e-4 for xyz and opacity, unequal "
                           f"for n_touched; not gated)")
                log(f"multi-device ({kind}, {mode}) over {label}: {ms:.1f} "
                    f"ms per iteration ({ms / ms1:.2f}x one device); {got}; "
                    f"launches {launches} (want {want} each), plain calls "
                    f"{plain}")
                if not ok:
                    raise SystemExit(f"multi-device segment ({kind}, {mode}, "
                                     f"{label}) disagrees with one device")
                if any(plain.values()) or any(v != want
                                              for v in launches.values()):
                    raise SystemExit(f"multi-device segment ({kind}, {mode}, "
                                     f"{label}) launched {launches}, plain "
                                     f"{plain}")
                for k in total:
                    total[k] += launches[k]
        if per_step:
            continue
        for fault in ("double Adam step", "replicas never refreshed"):
            with planted(fault):
                fz, _, _, _, _ = segment([dev] * 2, per_step, True)
                lv, _, _, _, _ = segment([dev] * 2, per_step, False)
            d = frozen_diff(fz, one[True])
            rel = live_rel(lv, losses)
            log(f"multi-device gates against a planted fault ({kind}, "
                f"{fault}, 2 entries of {dev}): frozen {frozen_fmt(d)}; live "
                f"loss outside one device's range by rel {rel:.2e} (tol "
                f"1e-5), {live_counts(lv, one[False])}")
            if frozen_ok(d) and rel <= 1e-5:
                raise SystemExit(f"the multi-device gates let the planted "
                                 f"fault through: {fault}")
    return total


def multidevice_phase(slam, dev):
    """Phase 14: the segments, B1/B2 against their plain versions on one
    shard's rows (the middle third of the window, as the 3-entry list
    splits it), then smoke_oracle.yaml, uncut, with mapping.mesh_devices 2:
    on one card the mapper falls back with JAX's message (on several it
    splits over two) and the run passes the oracle gate."""
    import contextlib
    import torch
    from splatslam_tpu_torch import resolve_device
    resolve_device(dev)     # the main path's map: no TF32
    total = multidevice_segments(slam)
    B = len(slam.mapper.current_window)
    r = torch.tensor_split(torch.arange(B), 3)[1]
    rows = slice(int(r[0]), int(r[-1]) + 1)
    shard = kernel_phase(f"multi-device shard 2 of 3 (window rows "
                         f"{rows.start}-{rows.stop - 1})",
                         *window_input(slam, rows))
    cfg = smoke_cfg("smoke_output_mesh", "configs/Synthetic/smoke_oracle.yaml")
    cfg["mapping"]["mesh_devices"] = 2
    n_vis = torch.cuda.device_count()
    log(f"multi-device SLAM: smoke_oracle.yaml with mapping.mesh_devices 2, "
        f"{n_vis} visible card(s); cuts: none")
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        counts, mslam, res = run_slam("mesh_devices 2 path", cfg, dev)
    line = ("[mapper] mesh_devices=2 requested but only 1 devices visible — "
            "running single-chip")
    if n_vis < 2:
        if line not in tee.kept.getvalue() or mslam.mapper.devices is not None:
            raise SystemExit("mesh_devices 2 on one card did not fall back "
                             "with JAX's message")
        log("multi-device SLAM: fell back with JAX's message")
    elif len(mslam.mapper.devices or ()) != 2:
        raise SystemExit(f"mesh_devices 2 on {n_vis} cards mapped on "
                         f"{mslam.mapper.devices}")
    if res["ate_rmse"] > 0.01:
        raise SystemExit(f"mesh_devices 2 path kf-ATE {res['ate_rmse']} "
                         "above 0.01")
    return total, shard


def pendulum_cfg(enable_loop, out_name):
    """tests/test_loop_closure.py's configuration: smoke.yaml tracking only,
    100 frames at 96x128 on the pendulum trajectory (loop_period 48, so the
    camera retraces its path), final BA off."""
    cfg = smoke_cfg(out_name)
    cfg.update(only_tracking=True, max_frames=100, eval_full_traj=False)
    cfg["synthetic"] = dict(cfg.get("synthetic", {}), n_frames=100, seed=11,
                            motion_scale=8.0, loop_period=48)
    cfg["cam"] = dict(cfg["cam"], H=96, W=128, fx=80.0, fy=80.0, cx=63.5,
                      cy=47.5, H_out=96, W_out=128, H_edge=0, W_edge=0)
    tr = cfg["tracking"]
    tr.update(buffer=96, warmup=5)
    tr["motion_filter"]["thresh"] = 0.8
    tr["frontend"].update(keyframe_thresh=0.4, window=10, max_factors=48,
                          enable_loop=enable_loop, enable_online_ba=False)
    tr["backend"].update(final_ba=False, loop_window=16, loop_nms=4,
                         loop_thresh=30.0)
    cfg["mono_prior"]["provider"] = "oracle"
    return cfg


def loop_phase(dev, learned_res):
    """Phase 15: the pendulum configuration with loop closure on and off.
    Gates: loop_ba fired with edges at least once, the loop arm's kf-ATE
    finite and at most 0.25. Also logs the learned path's loop_ba calls."""
    from splatslam_tpu_torch import slam as slam_mod
    from splatslam_tpu_torch.tracking import backend as BK
    arms = {}
    for enable in (True, False):
        edges = []
        cfg = pendulum_cfg(enable, f"pendulum_{'loop' if enable else 'noloop'}")
        t0 = time.perf_counter()
        slam = slam_mod.SLAM(cfg, device=dev)
        orig = spy_loop_ba(edges)
        try:
            res = slam.run()
        finally:
            BK.Backend.loop_ba = orig
        wall = time.perf_counter() - t0
        calls = slam.timers.count.get("fe.loop_ba", 0)
        arms[enable] = (res["ate_rmse"], edges)
        log(f"loop phase, loop {'on' if enable else 'off'}: frames "
            f"{res['n_frames']} keyframes {res['n_keyframes']} wall "
            f"{wall:.1f} s kf-ATE {res['ate_rmse']}; fe.loop_ba calls "
            f"{calls} ({res['timers'].get('fe.loop_ba', 0.0):.2f} s), "
            f"edges per call {edges}, of which loop calls with edges "
            f"{sum(1 for e in edges if e > 0)}")
    ate, edges = arms[True]
    log(f"loop phase: kf-ATE loop on {ate} vs off {arms[False][0]} (the "
        "JAX suite's CPU run: 0.2020 vs 0.2104); a record, the gates are "
        "edges and the 0.25 bound")
    if not edges or max(edges) <= 0:
        raise SystemExit(f"loop closure never built an edge: {edges}")
    if ate is None or not math.isfinite(ate) or ate > 0.25:
        raise SystemExit(f"loop arm kf-ATE {ate} not within 0.25")
    log(f"learned path (smoke.yaml): fe.loop_ba calls "
        f"{len(learned_res['loop_edges'])}, edges per call "
        f"{learned_res['loop_edges']}")


def trace_phase(dev, learned_res, n=12):
    """Phase 16: `python -m splatslam_tpu_torch.run` on smoke_oracle.yaml cut
    to `n` frames, without and then with `--profile DIR`. Gates: the trace
    exists and names both kernels and the loop's phases. Records its size
    and the run's wall both ways. Then the on_frame gate on the learned
    path."""
    import yaml
    from splatslam_tpu_torch import run as run_mod
    from splatslam_tpu_torch.utils.profiling import TRACE_FILE
    import shutil
    walls = {}
    # under build/ (ignored by git): the trace is measured, then deleted
    root = os.path.join(HERE, "build", "trace_phase")
    trace_dir = os.path.join(root, "trace")
    shutil.rmtree(root, ignore_errors=True)
    for traced in (False, True):
        tag = "traced" if traced else "plain"
        cfg = smoke_cfg("unused", "configs/Synthetic/smoke_oracle.yaml")
        cfg.pop("inherit_from", None)
        cfg.update(max_frames=n, eval_full_traj=False)
        cfg["synthetic"]["n_frames"] = n
        cfg["data"]["output"] = os.path.join(root, tag)
        path = os.path.join(root, f"{tag}.yaml")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            yaml.dump(cfg, f)
        t0 = time.perf_counter()
        run_mod.main([path] + (["--profile", trace_dir] if traced else []))
        walls[traced] = time.perf_counter() - t0
    trace = os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(trace):
        raise SystemExit("--profile wrote no trace")
    mb = os.path.getsize(trace) / 2**20
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    shutil.rmtree(root, ignore_errors=True)
    kernels = {k: sorted(x for x in names if k in x)
               for k in ("composite_fwd", "composite_bwd")}
    log(f"trace phase: smoke_oracle.yaml cut to {n} frames (depth only); "
        f"wall {walls[False]:.1f} s plain, {walls[True]:.1f} s traced "
        f"(overhead {walls[True] - walls[False]:.1f} s, "
        f"{100 * (walls[True] / walls[False] - 1):.0f}%); trace {mb:.1f} MB, "
        f"{len(events)} events, {n_kernels} device kernels, {len(names)} "
        f"distinct names; kernel names "
        f"{ {k: v[:2] for k, v in kernels.items()} }")
    if not all(kernels.values()):
        raise SystemExit("the trace names no composite_fwd/composite_bwd "
                         "kernel")
    for phase in ("motion_filter", "frontend", "mapping"):
        if phase not in names:
            raise SystemExit(f"the trace does not name phase {phase}")
    frames = learned_res["frames"]
    if [f[0] for f in frames] != list(range(learned_res["n_frames"])):
        raise SystemExit("on_frame was not called once per frame on the "
                         "learned path")
    log(f"trace phase: on_frame called once per frame on the learned path "
        f"({len(frames)} calls, keyframe index "
        f"{frames[0][2]} -> {frames[-1][2]})")


def tools_phase(dev):
    """Phase 17: the flow probe and the admission calibration on the shipped
    checkpoint at 240x320, and the ate_matrix `base` arm. Gate: the card's
    gap-1 EPE within 1e-3 relative of a CPU float32 run of the probe."""
    import torch
    from splatslam_tpu_torch.datasets import Synthetic
    from splatslam_tpu_torch.tools import admission_calib as AC
    from splatslam_tpu_torch.tools import ate_matrix as AM
    from splatslam_tpu_torch.tools import flow_probe as FP
    ds = Synthetic(FP.scene_cfg())
    t0 = time.perf_counter()
    model = FP.load_model(LEARNED_WEIGHTS, dev)
    probe = {}
    for gap in FP.GAPS:
        probe.update(FP.probe(model, ds, gaps=(gap,)))
        log("flow_probe: " + FP.format_line(gap, *probe[gap]))
    t_probe = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = FP.probe(FP.load_model(LEARNED_WEIGHTS, "cpu"), ds, gaps=(1,))[1]
    t_cpu = time.perf_counter() - t0
    rel = abs(probe[1][1] - cpu[1]) / abs(cpu[1])
    log(f"flow_probe: gap 1 EPE card {probe[1][1]:.6f} vs CPU float32 "
        f"{cpu[1]:.6f} px, rel {rel:.2e} (tol 1e-3); probe {t_probe:.1f} s "
        f"on the card, gap 1 {t_cpu:.1f} s on the CPU")
    if not rel <= 1e-3:
        raise SystemExit("flow probe: card and CPU EPE disagree")
    t0 = time.perf_counter()
    m = AC.load_model(LEARNED_WEIGHTS, dev)
    frames = AC.scene_frames(ds, dev)
    for th in AC.THRESHES:
        adm, deltas = AC.admission(m, frames, th)
        log("admission_calib: " + AC.format_line(th, adm, deltas,
                                                 len(frames)))
    log(f"admission_calib ({m.dtype}): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rmse, n_kf = AM.run_arm("base", AM.ARMS["base"], device=dev,
                            out=os.path.join(HERE, "chiprun_out",
                                             "ate_matrix"))
    log(f"ate_matrix: arm base {time.perf_counter() - t0:.1f} s")
    vals = [v for p in probe.values() for v in p] + [rmse]
    if not all(math.isfinite(v) for v in vals) or n_kf < 2:
        raise SystemExit(f"a tool gave a non-finite number: {vals}")
    torch.cuda.empty_cache()


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def judge_phase(ckpt, dev, ref=None):
    """--judge-only: the tools and one uncut smoke.yaml run on the
    reference checkpoint (`ref`, default the shipped
    pretrained/droid_dba.msgpack) and on `ckpt`, one line per tool and
    checkpoint (see the module docstring). Gates: every number finite for
    both; the reference's smoke kf-ATE within 0.25."""
    from splatslam_tpu_torch import slam as slam_mod
    from splatslam_tpu_torch.datasets import Synthetic
    from splatslam_tpu_torch.tools import admission_calib as AC
    from splatslam_tpu_torch.tools import ate_matrix as AM
    from splatslam_tpu_torch.tools import flow_probe as FP
    ref = ref or LEARNED_WEIGHTS
    for path in (ref, ckpt):
        if not os.path.isfile(path):
            raise SystemExit(f"judge: no checkpoint at {path}")
    log("judge, card: " + card_line())
    ds = Synthetic(FP.scene_cfg())
    out = {}
    for tag, path in (("shipped", ref), ("candidate", ckpt)):
        log(f"judge {tag}: {path} sha256 {sha256(path)}")
        r = out[tag] = {}
        t0 = time.perf_counter()
        probe = phase(f"judge {tag} flow_probe", lambda: FP.probe(
            FP.load_model(path, dev), ds))
        r["epe"] = {g: p[1] for g, p in sorted(probe.items())}
        r["first_delta"] = {g: p[2] for g, p in sorted(probe.items())}
        log(f"judge {tag} flow_probe ({time.perf_counter() - t0:.1f} s): "
            + "; ".join(f"gap {g} epe {p[1]:.4f} first_delta {p[2]:.3f} "
                        f"gt {p[0]:.2f} bias {p[3]:+.3f} px"
                        for g, p in sorted(probe.items())))

        def admission():
            m = AC.load_model(path, dev)
            frames = AC.scene_frames(ds, dev)
            return {th: len(AC.admission(m, frames, th)[0])
                    for th in AC.THRESHES}, len(frames), m.dtype
        t0 = time.perf_counter()
        adm, n, dtype = phase(f"judge {tag} admission_calib", admission)
        r["admitted"] = adm
        log(f"judge {tag} admission_calib ({dtype}, "
            f"{time.perf_counter() - t0:.1f} s): " + "; ".join(
                f"thresh {th:.2f} admitted {a}/{n}" for th, a in adm.items()))

        def base_arm():
            os.environ["SPLATSLAM_CKPT"] = path
            try:
                return AM.run_arm("base", AM.ARMS["base"], device=dev,
                                  out=os.path.join(HERE, "chiprun_out",
                                                   "judge", tag))
            finally:
                del os.environ["SPLATSLAM_CKPT"]
        t0 = time.perf_counter()
        r["ate_matrix_base"], n_kf = phase(f"judge {tag} ate_matrix",
                                           base_arm)
        log(f"judge {tag} ate_matrix base ({time.perf_counter() - t0:.1f} "
            f"s): kf-ATE {r['ate_matrix_base']} keyframes {n_kf}")

        def smoke():
            cfg = smoke_cfg(os.path.join("judge", tag, "smoke"))
            cfg["tracking"]["pretrained"] = path
            return slam_mod.SLAM(cfg, device=dev).run()
        t0 = time.perf_counter()
        res = phase(f"judge {tag} smoke.yaml", smoke)
        if res["weights"] != path:
            raise SystemExit(f"judge {tag}: smoke.yaml ran on "
                             f"{res['weights']!r}, not {path}")
        r.update({k: res[k] for k in ("ate_rmse", "full_ate_rmse", "psnr",
                                      "n_keyframes")})
        log(f"judge {tag} smoke.yaml ({time.perf_counter() - t0:.1f} s, "
            f"uncut): kf-ATE {res['ate_rmse']} full ATE "
            f"{res['full_ate_rmse']} PSNR {res['psnr']} keyframes "
            f"{res['n_keyframes']} of {res['n_frames']} frames")
        vals = [*r["epe"].values(), *r["first_delta"].values(),
                r["ate_matrix_base"], r["ate_rmse"], r["full_ate_rmse"],
                r["psnr"]]
        if not all(v is not None and math.isfinite(v) for v in vals):
            raise SystemExit(f"judge {tag}: a number is not finite: {r}")
    ship, cand = out["shipped"]["ate_rmse"], out["candidate"]["ate_rmse"]
    log(f"judge: smoke kf-ATE shipped {ship} (gate <= 0.25), candidate "
        f"{cand} ({'within' if cand <= 0.25 else 'ABOVE'} the 0.25 bound, "
        f"{cand / ship:.2f}x the shipped)")
    log("judge: " + json.dumps(out))
    if not ship <= 0.25:
        raise SystemExit(f"judge: the shipped checkpoint's kf-ATE {ship} is "
                         "above 0.25")


def dba_eval(ckpts, dev, n_batches=32, batch=2, N=7, iters=8, seed=0):
    """--dba-eval: each checkpoint through the DBA stage's loss with no
    update, on the same seeded batches per bucket (see the module
    docstring). Gate: every loss and ATE finite."""
    import numpy as np
    import torch
    from splatslam_tpu_torch import resolve_device
    from splatslam_tpu_torch.models.weights import load_selftrained
    from splatslam_tpu_torch.train import droid_trainer as T
    dev = resolve_device(dev)
    for path in ckpts:
        if not os.path.isfile(path):
            raise SystemExit(f"dba-eval: no checkpoint at {path}")
        log(f"dba-eval: {path} sha256 {sha256(path)}")
    log(f"dba-eval, card: {card_line()}; {n_batches} batches of {batch} "
        f"sequences (make_seq_batch, seed {seed}, N={N}) per bucket, "
        f"{iters} rounds, no update")
    out = {}
    for H, W, fx in T.FLOW_BUCKETS:
        t0 = time.perf_counter()
        rng = np.random.RandomState(seed)
        batches = [T.make_seq_batch(rng, batch, N, H, W, fx)
                   for _ in range(n_batches)]
        log(f"dba-eval {H}x{W}: rendered in {time.perf_counter() - t0:.1f} "
            "s (host)")
        for path in ckpts:
            model = load_selftrained(path, device=dev)
            t0 = time.perf_counter()
            loss, ate = [], []
            with torch.no_grad():
                for b in batches:
                    ls, at = T.dba_batch_loss(model, *[t.to(dev) for t in b],
                                              N=N, iters=iters)
                    loss.append(float(ls.mean()))
                    ate.append(float(at.mean()))
            r = out.setdefault(path, {})[f"{H}x{W}"] = dict(
                loss_mean=float(np.mean(loss)),
                loss_median=float(np.median(loss)),
                ate_mean=float(np.mean(ate)), ate_median=float(np.median(ate)),
                ate_p10=float(np.percentile(ate, 10)),
                ate_p90=float(np.percentile(ate, 90)))
            log(f"dba-eval {path} {H}x{W} ({time.perf_counter() - t0:.1f} "
                f"s): loss mean {r['loss_mean']:.5f} median "
                f"{r['loss_median']:.5f}; ATE mean {r['ate_mean']:.5f} median "
                f"{r['ate_median']:.5f} (p10 {r['ate_p10']:.5f}, p90 "
                f"{r['ate_p90']:.5f})")
            if not np.isfinite(loss + ate).all():
                raise SystemExit(f"dba-eval {path} {H}x{W}: a loss or ATE "
                                 "is not finite")
            del model
            torch.cuda.empty_cache()
    log("dba-eval: " + json.dumps(out))


def train_cli(argstr):
    """--train-cli: train_droid's main() on `argstr` in this process, every
    step recorded (see the module docstring)."""
    import shlex
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from splatslam_tpu_torch import resolve_device, train_droid
    from splatslam_tpu_torch.models.weights import init_params
    from splatslam_tpu_torch.train import droid_trainer as T
    argv = shlex.split(argstr)
    args = train_droid.build_parser().parse_args(argv)
    stages = {"flow": ["flow"], "dba": ["dba"],
              "both": ["flow", "dba"]}[args.stage]
    outs = {"flow": args.out, "dba": args.dba_out}
    pre = os.path.join(HERE, "pretrained") + os.sep
    for st in stages:
        if os.path.abspath(outs[st]).startswith(pre):
            raise SystemExit(f"train_droid: the {st} stage would write "
                             f"{outs[st]}, under pretrained/")
    if stages == ["dba"] and not os.path.isfile(args.out):
        raise SystemExit(f"train_droid: the dba stage starts from --out "
                         f"{args.out}, which does not exist")
    log(f"train_droid {' '.join(argv)}; card: {card_line()}")
    rec = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_droid.main(argv, records=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train_droid: main() {wall:.1f} s, peak device memory {peak:.2f} "
        f"GiB{'' if len(stages) == 1 else ' (both stages)'}")

    buckets = T.FLOW_BUCKETS if args.buckets == "both" else ((96, 128, 80.0),)
    dev = resolve_device(args.device)
    os.makedirs(os.path.join(HERE, "chiprun_out", "train"), exist_ok=True)
    metric = {"flow": "epe", "dba": "ate"}
    for st in stages:
        r = rec[st]
        steps = r["steps"]
        with open(os.path.join(HERE, "chiprun_out", "train",
                               f"{st}_records.json"), "w") as f:
            json.dump(r, f)
        bad = [x["step"] for x in steps if not all(
            math.isfinite(x[k]) for k in ("loss", metric[st], "gnorm"))]
        wait = sum(x["wait_ms"] for x in steps) / 1e3
        busy = sum(x["ms"] for x in steps) / 1e3
        log(f"train_droid {st}: {len(steps)} steps, loop wall "
            f"{r['wall_s']:.1f} s (steps {busy:.1f} s, waiting for host "
            f"batches and their upload {wait:.1f} s = "
            f"{100 * wait / r['wall_s']:.1f}%); {outs[st]} "
            f"{os.path.getsize(outs[st])} bytes sha256 {sha256(outs[st])}")
        for H, W, fx in buckets:
            ms = [x["ms"] for x in steps if tuple(x["shape"]) == (H, W)]
            if not ms:
                continue
            # FLOPs of one step at this bucket on a fresh net (the count
            # does not depend on the weights)
            model = init_params(torch.Generator().manual_seed(0), device=dev)
            opt = T.make_optimizer(model, 1e-4, 10)
            rng = np.random.RandomState(0)
            if st == "flow":
                step = T.make_train_step(model, opt, iters=8)
                batch = T.make_pair_batch(rng, args.batch, H, W, fx)
            else:
                step = T.make_dba_train_step(model, opt, N=7, iters=8)
                batch = T.make_seq_batch(rng, args.dba_batch, 7, H, W, fx)
            batch = [t.to(dev) for t in batch]
            with FlopCounterMode(display=False) as fc:
                step(*batch)
            flops = fc.get_total_flops()
            del model, opt, step, batch
            torch.cuda.empty_cache()
            rest = sorted(ms[2:]) or sorted(ms)
            med = rest[len(rest) // 2]
            waits = sorted(x["wait_ms"] for x in steps
                           if tuple(x["shape"]) == (H, W))
            log(f"train_droid {st} {H}x{W}: {len(ms)} steps, {med:.1f} ms "
                f"per step (median after the first two), p10 "
                f"{rest[len(rest) // 10]:.1f} p90 "
                f"{rest[(9 * len(rest)) // 10]:.1f} ms; wait median "
                f"{waits[len(waits) // 2]:.1f} ms; {flops / 1e12:.4f} TFLOP "
                f"a step (FlopCounterMode), {flops / med / 1e9:.3f} TFLOP/s "
                "at the median")
        # the curve: means over windows of a tenth of the run, by bucket
        n = max(1, len(steps) // 10)
        for a in range(0, len(steps), n):
            win = steps[a:a + n]
            by = {}
            for x in win:
                by.setdefault(tuple(x["shape"]), []).append(x)
            log(f"train_droid {st} curve steps {a}-{a + len(win) - 1}: "
                + "; ".join(
                    f"{h}x{w} n {len(v)} loss "
                    f"{np.mean([x['loss'] for x in v]):.4f} {metric[st]} "
                    f"{np.mean([x[metric[st]] for x in v]):.4f}"
                    for (h, w), v in sorted(by.items())))
        if bad:
            raise SystemExit(f"train_droid {st}: a loss, {metric[st]} or "
                             f"gnorm is not finite from step {bad[0]}")


# ---------------------------------------------------------------------------
# phase 18: the per-layer profilers
# ---------------------------------------------------------------------------

PROFILER_RUNS = (
    ("kernel_bench", []),
    ("tracking_profile", []),
    ("map_step_profile", []),
    ("map_step_profile", ["--ssim", "--dense"]),
)


def profilers_phase(dev):
    """Phase 18: the three profilers at the JAX tools' default shapes
    through their entry points, launch counts reset just before and read
    just after; then B1/B2 on the profiler's own cloud against their plain
    versions. Returns (launch counts, {cloud: kernel-phase measurements})."""
    import importlib
    import torch
    from splatslam_tpu_torch.ops import raster_cuda, rasterizer as R
    log("profilers phase, card: " + card_line())
    raster_cuda.reset_launch_counts()
    for k in R.plain_calls:
        R.plain_calls[k] = 0
    t0 = time.perf_counter()
    lines = []
    for name, argv in PROFILER_RUNS:
        mod = importlib.import_module(f"splatslam_tpu_torch.tools.{name}")
        t1 = time.perf_counter()
        out = mod.main(argv + ["--json", "--device", str(dev)])
        log(f"{name} {' '.join(argv)}: {time.perf_counter() - t1:.1f} s")
        lines.append((name, argv, out))
    torch.cuda.synchronize()
    counts = dict(raster_cuda.launches)
    plain = dict(R.plain_calls)
    log(f"launches on the profilers' path: {counts}; plain compositing calls "
        f"{plain}; {time.perf_counter() - t0:.1f} s")
    for name, argv, out in lines:
        rows = {k: v for k, v in out.items() if k.endswith("_ms")}
        bad = {k: v for k, v in rows.items()
               if not (math.isfinite(v) and v > 0)}
        if not rows or bad:
            raise SystemExit(f"{name} {argv}: rows not finite and > 0: {bad}")
    if min(counts.values()) <= 0:
        raise SystemExit(f"a kernel never launched on the profilers' path: "
                         f"{counts}")
    if any(plain.values()):
        raise SystemExit(f"the profilers ran a plain compositor: {plain}")
    from splatslam_tpu_torch.tools import map_step_profile as MSP
    clouds = {}
    for label, argv in (("profiler cloud", []),
                        ("profiler dense cloud", ["--dense"])):
        s = MSP.setup(MSP.build_parser().parse_args(argv), dev)
        clouds[label] = kernel_phase(label, s.packets, s.tile_ids,
                                     s.tile_counts, s.ntx,
                                     referee=bool(argv))
        del s
        torch.cuda.empty_cache()
    return counts, clouds


# ---------------------------------------------------------------------------
# phase 19: the benchmark
# ---------------------------------------------------------------------------

# the bench's four modes cut to 24 measured frames (the smoke scenes' 40,
# replica_scale's 60 at the bench's defaults), a 6-frame prime and 32 final
# refinement iterations: widths, capacities and windows stay the configs'
BENCH_CUT = {"BENCH_FRAMES": "24", "BENCH_PRIME_FRAMES": "6",
             "BENCH_REFINE": "32"}
BENCH_MODES = ("learned", "oracle", "replica_scale", "dpt")
# kf-ATE gates of PERF.md §2 by mode (the oracle and learned paths' own)
BENCH_ATE = {"oracle": 0.01, "learned": 0.25}


def bench_env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_OUT=os.path.join(HERE, "chiprun_out", "bench"), **kw)
    return env


def bench_lines(text, label):
    try:
        return [json.loads(x) for x in text.splitlines()]
    except json.JSONDecodeError as e:
        raise SystemExit(f"{label}: a stdout line is not JSON: {e}")


def bench_phase():
    """Phase 19: `python -m splatslam_tpu_torch.bench` as a subprocess over
    its four modes at BENCH_CUT, on the kernels already built; its stdout
    and stderr go to bench.out and bench.err beside the paths' outputs.
    Gates: exit 0, every
    stdout line JSON, one final line a mode without `error`, kf-ATE gates,
    achieved_tflops > 0 and 0 < mfu < 1.05, prime_ok, the probe names this
    card, the last line is the oracle final, and in each mode's measured
    run (the bench's `launches` events, counted from 0 just before it) both
    kernels launched and no plain compositor ran. Then a short run (two
    oracle modes, 8 frames, no prime) gets SIGTERM after its second mode's
    first partial line: exit 0, that mode's partial line, then the first
    mode's final. Returns the launch counts summed over the four modes."""
    import torch
    log(f"bench phase, card: {card_line()}; cut: {BENCH_CUT}")
    torch.cuda.empty_cache()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    # TF32_CHILD: `python -m splatslam_tpu_torch.bench` that exits 3 if the
    # bench ends with TF32 on
    r = subprocess.run([sys.executable, "-c", TF32_CHILD,
                        "splatslam_tpu_torch.bench"],
                       cwd=HERE, env=bench_env(**BENCH_CUT),
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for ext, text in (("out", r.stdout), ("err", r.stderr)):
        with open(os.path.join(out_dir, f"bench.{ext}"), "w") as f:
            f.write(text)
    log(f"bench: exit {r.returncode} in {wall:.1f} s; stderr tail:\n"
        + "\n".join(r.stderr.splitlines()[-5:]))
    lines = bench_lines(r.stdout, "bench")
    finals = {}
    for x in lines:
        if not x.get("partial", True) or "error" in x:
            finals.setdefault(x["metric"], x)
    for x in finals.values():
        log("bench final: " + json.dumps(
            {k: v for k, v in x.items() if k not in ("phases", "probe")}))
    log("bench probe: " + json.dumps(lines[-1].get("probe")))
    events = [json.loads(x) for x in r.stderr.splitlines()
              if x.startswith('{"event"')]
    launches = {e["mode"]: e for e in events if e["event"] == "launches"}
    log("bench launches: " + json.dumps(launches))
    if r.returncode != 0:
        raise SystemExit(f"bench exited {r.returncode}")
    card = card_line().split(",")[0].strip()
    counts = {"composite_fwd": 0, "composite_bwd": 0}
    for mode in BENCH_MODES:
        f = finals.get(f"e2e_fps_synthetic_{mode}")
        if f is None or f["partial"] or "error" in f:
            raise SystemExit(f"bench: no final line for {mode}: {f}")
        if mode in BENCH_ATE and not f["kf_ate_rmse"] <= BENCH_ATE[mode]:
            raise SystemExit(f"bench {mode}: kf-ATE {f['kf_ate_rmse']} above "
                             f"{BENCH_ATE[mode]}")
        if not (f.get("achieved_tflops", 0) > 0
                and 0 < f.get("mfu", 0) < 1.05 and f["prime_ok"]):
            raise SystemExit(f"bench {mode}: achieved_tflops/mfu/prime_ok "
                             f"out of range: {f}")
        if f["probe"]["device"] != card:
            raise SystemExit(f"bench probe names {f['probe']['device']}, "
                             f"not {card}")
        e = launches.get(mode, {})
        if min(e.get(k, 0) for k in counts) <= 0 or any(
                e.get("plain", {}).values()):
            raise SystemExit(f"bench {mode}: a kernel never launched or a "
                             f"plain compositor ran: {e}")
        for k in counts:
            counts[k] += e[k]
    if lines[-1]["metric"] != "e2e_fps_synthetic_oracle" or \
            lines[-1]["partial"]:
        raise SystemExit(f"bench: the last line is not the oracle final: "
                         f"{lines[-1]}")

    p = subprocess.Popen(
        [sys.executable, "-m", "splatslam_tpu_torch.bench"], cwd=HERE,
        env=bench_env(BENCH_MODES="oracle,oracle", BENCH_FRAMES="8",
                      BENCH_PRIME="0", BENCH_REFINE="8",
                      BENCH_TUNNEL_PROBE_S="0"),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        seen = []
        for raw in p.stdout:
            seen.append(json.loads(raw))
            if len(seen) >= 2 and seen[-2]["partial"] is False:
                break
        p.send_signal(signal.SIGTERM)
        rest, _ = p.communicate(timeout=120)
    finally:
        p.kill()
        p.wait(timeout=60)
    rest = bench_lines(rest, "bench SIGTERM run")
    log(f"bench SIGTERM run: exit {p.returncode}; lines after the signal: "
        + json.dumps(rest))
    if p.returncode != 0 or len(seen) < 2 or len(rest) < 2 or \
            not all(x["partial"] for x in rest[:-1]) or \
            rest[-1] != seen[-2]:
        raise SystemExit("bench: SIGTERM did not print the partial line and "
                         "then the last final line with exit 0")
    log(f"bench phase: {time.perf_counter() - t0:.1f} s")
    return counts


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
    ap.add_argument("--last-only", action="store_true",
                    help="only the build and phases 14-17 (multi-device "
                    "mapping, loop closure, trace and hook, tools)")
    ap.add_argument("--multidevice-only", action="store_true",
                    help="only the build, the replica_scale path and phase "
                    "14 (over distinct cards where several are visible)")
    ap.add_argument("--profilers-only", action="store_true",
                    help="only the build and the profilers phase")
    ap.add_argument("--bench-only", action="store_true",
                    help="only the build and the benchmark phase")
    ap.add_argument("--judge-only", metavar="CKPT", default=None,
                    help="only the build, then the tools and smoke.yaml on "
                    "the shipped tracker checkpoint and on CKPT")
    ap.add_argument("--judge-ref", metavar="REF", default=None,
                    help="with --judge-only: the checkpoint CKPT is judged "
                    "beside (default pretrained/droid_dba.msgpack)")
    ap.add_argument("--dba-eval", metavar="CKPT", nargs="+", default=None,
                    help="only the build, then each checkpoint through the "
                    "DBA stage's loss with no update, at both buckets")
    ap.add_argument("--train-cli", metavar="ARGS", default=None,
                    help="only the build, then train_droid's main() on ARGS "
                    "(one string), timed step by step")
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
    # no process-wide TF32 switch here: every phase turns TF32 on and must
    # find it off again (phase)
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

    def window_phase(label, slam, rows=slice(None)):
        return phase(label, lambda: kernel_phase(
            label, *window_input(slam, rows)))

    if args.train_only:
        phase("trainer phase", trainer_phase, dev, both_buckets=True)
        check_pretrained()
        refuse_jax()
        return 0
    if args.judge_only:
        judge_phase(args.judge_only, dev, args.judge_ref)
        check_pretrained()
        refuse_jax()
        return 0
    if args.dba_eval:
        phase("dba-eval", dba_eval, args.dba_eval, dev)
        check_pretrained()
        refuse_jax()
        return 0
    if args.train_cli:
        phase("train_droid", train_cli, args.train_cli)
        check_pretrained()
        refuse_jax()
        return 0
    if args.last_only:
        _, slam = phase("main path", main_path, dev)
        phase("multi-device phase", multidevice_phase, slam, dev)
        del slam
        torch.cuda.empty_cache()
        _, learned, learned_res = phase("learned path", learned_path, dev)
        del learned
        torch.cuda.empty_cache()
        phase("loop phase", loop_phase, dev, learned_res)
        phase("trace phase", trace_phase, dev, learned_res)
        phase("tools phase", tools_phase, dev)
        check_pretrained()
        refuse_jax()
        return 0
    if args.multidevice_only:
        _, slam = phase("main path", main_path, dev)
        phase("multi-device phase", multidevice_phase, slam, dev)
        refuse_jax()
        return 0
    if args.profilers_only:
        phase("profilers phase", profilers_phase, dev)
        refuse_jax()
        return 0
    if args.bench_only:
        phase("bench phase", bench_phase, in_child=True)
        check_pretrained()
        refuse_jax()
        return 0
    if args.learned_only:
        _, learned, _ = phase("learned path", learned_path, dev)
        window_phase("learned final window", learned)
        phase("network phase", network_phase, learned, dev)
        refuse_jax()
        return 0
    if args.prior_only:
        _, prior = phase("prior path", prior_path, dev, None)
        window_phase("prior final window", prior)
        phase("DPT phase", dpt_phase, prior, dev)
        phase("mesh phase", mesh_phase, prior, dev)
        phase("recorded path", recorded_path, prior, dev)
        refuse_jax()
        return 0
    inputs = phase("kernel input", kernel_input, dev)
    cloud = phase("kernel phase", kernel_phase, "kernel phase", *inputs,
                  time_flags=time_flags)
    # one camera of the same cloud: the grid of the map initialisation and
    # of the final refinement, most of the main path's launches
    single = phase("one camera", kernel_phase, "one camera", *[
        x[:1].contiguous() if torch.is_tensor(x) else x for x in inputs])
    if args.sweep_pixels_per_thread:
        sweep_pixels_per_thread(*inputs)
    dspo = phase("DSPO kernel phase", dspo_phase, dev)
    if args.kernels_only:
        log(json.dumps(dict(kernel_phase=cloud, one_camera=single,
                            dspo=dspo)))
        return 0
    counts, slam = phase("main path", main_path, dev)
    window = window_phase("final window", slam)
    phase("profile phase", profile_phase, slam)
    counts_multi, window_shard = phase("multi-device phase",
                                       multidevice_phase, slam, dev)
    del slam
    torch.cuda.empty_cache()
    counts_learned, learned, learned_res = phase("learned path",
                                                 learned_path, dev)
    window_learned = window_phase("learned final window", learned)
    phase("network phase", network_phase, learned, dev)
    del learned
    torch.cuda.empty_cache()
    counts_prior, prior = phase("prior path", prior_path, dev, learned_res)
    window_prior = window_phase("prior final window", prior)
    phase("DPT phase", dpt_phase, prior, dev)
    phase("mesh phase", mesh_phase, prior, dev)
    counts_recorded = phase("recorded path", recorded_path, prior, dev)
    del prior
    torch.cuda.empty_cache()
    phase("trainer phase", trainer_phase, dev)
    phase("loop phase", loop_phase, dev, learned_res)
    phase("trace phase", trace_phase, dev, learned_res)
    phase("tools phase", tools_phase, dev)
    counts_profilers, profiler_clouds = phase("profilers phase",
                                              profilers_phase, dev)
    counts_bench = phase("bench phase", bench_phase, in_child=True)
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
            launches_recorded=counts_recorded[name],
            launches_multidevice=counts_multi[name],
            launches_profilers=counts_profilers[name],
            launches_bench=counts_bench[name], **m,
            one_camera={k: v for k, v in single[name].items()
                        if k != "library_ms"},
            window={k: v for k, v in w.items() if k != "library_ms"},
            learned_window={k: v for k, v in window_learned[name].items()
                            if k != "library_ms"},
            prior_window={k: v for k, v in window_prior[name].items()
                          if k != "library_ms"},
            multidevice_shard={k: v for k, v in window_shard[name].items()
                               if k != "library_ms"},
            **{label.replace(" ", "_"): {k: v for k, v in c[name].items()
                                         if k != "library_ms"}
               for label, c in profiler_clouds.items()}))
    for label, m in dspo.items():
        kernels.append(dict(
            name="depth_filter" if label.startswith("filter")
            else "scale_shift_iteration", input=label, route="cuda",
            source="splatslam_tpu_torch/csrc/dspo.cu", replaces=None,
            launches=counts["scale_shift_iteration" if "round" in label
                            else "depth_filter"], **m))
    refuse_jax()
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
