"""Self-training for the DROID update operator on synthetic flow data
(counterpart of splatslam_tpu/train/droid_trainer.py).

Two stages, both on batches rendered on the host from random procedural
Synthetic scenes:

  * flow (`train`): RAFT-style iterative flow refinement on frame pairs
    with ground-truth correspondence. Per step, K update iterations
        corr = lookup(corr_pyramid, coords)
        net, delta, weight = update(net, inp, corr, motion_features)
        coords = stop_gradient(coords) + delta
    with the exponentially weighted flow loss, a confidence target
    exp(-|err|) for the weight head, and a full-resolution flow loss
    through the learned convex upsampler (trains GraphAgg's upmask head);
  * DBA (`train_dba`): N-frame sequences through the update operator and
    the differentiable bundle adjustment layer (ops/ba.dba), supervised on
    poses, disparities and flow after every round.

Everything is plain PyTorch under autograd, float32 (the caller keeps TF32
off on the GPU, as the JAX package's parity runs are full float32). Where
the JAX code takes a subgradient at a kink (|x| at 0, max/clip at a tie)
the port takes the same one (`_abs`, `_clip`, ops/corr's hat), so the two
packages agree on gradients and not only on values.

Differences from the JAX file, on purpose:
  * the batch renderers return CPU tensors; the training loop uploads them
    (the worker threads never touch the device);
  * `jax.vmap` over the scenes of a DBA batch is a loop: each scene's loss
    is back-propagated on its own (divided by the batch), which sums to
    the gradient of the mean and holds one scene's graph at a time;
  * `jax.checkpoint` of a round is `torch.utils.checkpoint`;
  * the parameters are a trainable DroidNet (models/weights.init_params),
    and the optimizer is `make_optimizer`, the exact counterpart of the
    optax chain.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..datasets import Synthetic
from ..models.droid_net import normalize_images
from ..models.dpt import resize
from ..models.weights import init_params, load_selftrained, save_droid_params
from ..ops import corr as corr_ops
from ..ops import lie, projective as pops
from ..ops.ba import dba, make_edges
from ..ops.upsample import cvx_upsample


def _abs(x):
    """|x| with JAX's slope +1 at 0 (torch.abs has 0 there)."""
    return torch.where(x >= 0, x, -x)


def _clip(x, lo, hi):
    """jnp.clip as jnp.minimum(jnp.maximum(x, lo), hi): a tie at a bound
    splits its gradient (torch.clamp would pass all of it)."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _synthetic(H, W, fx_s, syn):
    return Synthetic({
        "dataset": "synthetic",
        "cam": {"H": H, "W": W, "fx": fx_s, "fy": fx_s,
                "cx": W / 2 - 0.5, "cy": H / 2 - 0.5,
                "H_out": H, "W_out": W, "H_edge": 0, "W_edge": 0},
        "synthetic": syn})


def _w2c(c2w):
    """c2w 4×4 (numpy) → SE3 7-vec w2c, by the port's from_matrix on a CPU
    float32 tensor: the function the JAX renderers call, on the same
    float32 input."""
    T = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32)
    return lie.from_matrix(T)


def _disp8(d, h, w, off=3):
    d8 = d[off::8, off::8][:h, :w]
    return np.where(d8 > 1e-6, 1.0 / np.maximum(d8, 1e-6), 0.0)


def make_pair_batch(rng: np.random.RandomState, batch: int, H: int, W: int,
                    fx: float = 80.0):
    """Render `batch` frame pairs with GT flow at 1/8 resolution, as CPU
    tensors (img1, img2 (B,H,W,3), flow (B,H/8,W/8,2), valid (B,H/8,W/8)).

    Draws from `rng` in the JAX package's order, so one seed gives the same
    pairs in both packages. Focal length and motion magnitude are sampled
    wide so the observed 1/8-res flows span ~0.2-8 px, the range the
    tracker sees at the SLAM resolutions. The frame gap mixes the regimes
    the tracker meets: 40% gaps 1-3 (admission), 45% gaps 1-10 (window
    proximity edges), 15% full-period revisits on a pendulum trajectory
    (loop closure: a huge temporal gap, near-zero true motion). Both
    positions are random along the trajectory: pairs fixed at frames
    (0, 1) would share one motion direction, which the net memorises."""
    imgs1, imgs2, flows, valids = [], [], [], []
    h, w = H // 8, W // 8
    for _ in range(batch):
        fx_s = float(fx * (0.7 + 1.8 * rng.rand()))
        k0 = int(rng.randint(0, 60))
        u = rng.rand()
        loop_period = 0
        if u < 0.15:
            loop_period = int(24 + rng.randint(48))
            gap = loop_period
            k0 = int(rng.randint(0, 16))
        elif u < 0.55:
            gap = int(1 + rng.randint(3))
        else:
            gap = int(1 + rng.randint(10))
        syn = {"n_frames": k0 + gap + 1,
               "seed": int(rng.randint(1 << 30)),
               "motion_scale": float(0.5 + 9.5 * rng.rand())}
        if loop_period:
            syn["loop_period"] = loop_period
        ds = _synthetic(H, W, fx_s, syn)
        _, im1, d1, p1 = ds[k0]
        _, im2, _, p2 = ds[k0 + gap]
        imgs1.append(im1)
        imgs2.append(im2)
        disp8 = torch.as_tensor(_disp8(d1, h, w))
        poses = torch.stack([_w2c(p1), _w2c(p2)])
        intr8 = torch.tensor([fx_s / 8, fx_s / 8, (W / 2 - 0.5) / 8,
                              (H / 2 - 0.5) / 8])
        coords, valid = pops.projective_transform(
            poses[None], disp8[None, None].repeat(1, 2, 1, 1),
            intr8.expand(2, 4)[None], torch.tensor([0]), torch.tensor([1]))
        flows.append(coords[0, 0])
        valids.append(valid[0, 0, ..., 0])
    return (torch.as_tensor(np.stack(imgs1)), torch.as_tensor(np.stack(imgs2)),
            torch.stack(flows), torch.stack(valids))


def flow_loss(model, img1, img2, flow_gt, valid, iters: int = 8):
    """The flow stage's loss on one batch: (loss, epe), both scalars that
    carry the graph. img (B,H,W,3) in [0,1]; flow_gt (B,h,w,2) target
    coordinates; valid (B,h,w)."""
    B, H, W, _ = img1.shape
    h, w = H // 8, W // 8
    coords0 = pops.coords_grid(h, w, device=img1.device)
    x = normalize_images(torch.cat([img1, img2], 0))
    fmaps = model.features(x)
    f1, f2 = fmaps[:B], fmaps[B:]
    cn, ci = model.context(normalize_images(img1))
    pyr = corr_ops.build_corr_pyramid(f1.float(), f2.float())
    net = cn
    coords = coords0.expand(B, h, w, 2)
    total = 0.0
    w_loss = 0.0
    vmask = valid[..., None]
    for k in range(iters):
        corr = corr_ops.lookup_pyramid(pyr, coords)
        # inference-matching motion features: [coords-coords0,
        # target-coords] with target == current coords (no GT leak)
        motn = torch.cat([_clip(coords - coords0, -64.0, 64.0),
                          torch.zeros_like(coords)], -1)
        net, delta, weight = model.update_step(net, ci, corr,
                                               motn.permute(0, 3, 1, 2))
        coords = coords.detach() + delta.permute(0, 2, 3, 1)
        err = _abs(coords - flow_gt) * vmask
        gamma = 0.8 ** (iters - k - 1)
        total = total + gamma * err.mean()
        conf_target = torch.exp(-err.detach())
        w_loss = w_loss + gamma * (_abs(weight.permute(0, 2, 3, 1)
                                        - conf_target) * vmask).mean()
    # full-res flow loss through the learned convex upsampler
    ix = torch.arange(B, device=img1.device)
    _, upmask = model.update_agg(net, ix, B)
    up_flow = cvx_upsample(coords - coords0, upmask.permute(0, 2, 3, 1)) * 8.0
    # jax.image.resize "bilinear" through the same weight matrices; its
    # "nearest" samples at half-pixel centres, which is nearest-exact
    gt_up = resize(((flow_gt - coords0) * 8.0).permute(0, 3, 1, 2), (H, W),
                   "bilinear").permute(0, 2, 3, 1)
    vup = torch.nn.functional.interpolate(
        vmask.permute(0, 3, 1, 2).float(), size=(H, W),
        mode="nearest-exact").permute(0, 2, 3, 1)
    up_loss = (_abs(up_flow - gt_up) * vup).mean()
    loss = total + 0.2 * w_loss + 0.1 * up_loss
    epe = (torch.linalg.norm(coords - flow_gt, dim=-1) * valid).sum() \
        / valid.sum().clamp(min=1)
    return loss, epe


class ClippedAdamW:
    """optax.chain(clip_by_global_norm(1.0), adamw(cosine_decay_schedule(
    lr, steps, 0.05))) on the trainable parameters of a module, exactly:

      * the clip scales every gradient by 1/norm only when norm ≥ 1, as
        t / norm · 1 (torch's clip_grad_norm_ divides by norm + 1e-6 and
        always scales);
      * AdamW with optax's defaults: b1 0.9, b2 0.999, eps 1e-8, weight
        decay 1e-4 scaled by the scheduled lr (torch's default decay is
        1e-2);
      * the lr of update t (t updates already applied) is
        lr·(0.95·½(1+cos(π·min(t,steps)/steps)) + 0.05), a LambdaLR of that
        closed form.

    `step()` applies one update from the gradients in `.grad` and returns
    the global norm before the clip (a 0-dim tensor)."""

    max_norm = 1.0

    def __init__(self, model, lr: float, steps: int):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda t: 0.95 * 0.5 * (
                1.0 + math.cos(math.pi * min(t, steps) / steps)) + 0.05)

    def step(self):
        # a parameter the loss does not reach (the flow stage never uses
        # the eta head) has no .grad; optax still decays it and its
        # moments, so it gets a zero gradient rather than being skipped
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        # accumulated in float64: a float32 norm of a 0.5 M-element tensor
        # is off by ~1e-5 relative on the CPU, optax's by ~1e-6
        gnorm = torch.linalg.vector_norm(
            torch.cat([g.reshape(-1) for g in grads]),
            dtype=torch.float64).float()
        # optax's form, (t / norm) * max_norm, only at norm ≥ max_norm (else
        # t / 1 * 1); on the device, without a host round trip
        clip = gnorm >= self.max_norm
        one = torch.ones_like(gnorm)
        torch._foreach_div_(grads, torch.where(clip, gnorm, one))
        torch._foreach_mul_(grads, torch.where(clip, self.max_norm * one,
                                               one))
        self.opt.step()
        self.sched.step()
        return gnorm

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)


def make_optimizer(model, lr: float, steps: int) -> ClippedAdamW:
    """The trainer's optimizer (both stages): global-norm clip at 1.0, then
    AdamW under a cosine decay to 5% of `lr` over `steps` updates.

    Clipping deviates from the reference DELIBERATELY, as in the JAX
    package: the reference registers a backward hook that zeroes
    per-ELEMENT grads with |g| > 0.01 (and NaNs) inside the update module
    (glorie_slam/modules/droid_net/clipping.py:19-40) — a remedy for
    exploding BA backprop on its training rig, tuned to its scale and
    unroll depth. For a from-scratch net, global-norm clipping is the
    standard choice: it preserves gradient direction instead of flattening
    any step where many elements exceed a fixed 0.01 cut. The two rules are
    NOT equivalent training dynamics; if a converted reference checkpoint
    is ever fine-tuned here, revisit."""
    return ClippedAdamW(model, lr, steps)


def make_train_step(model, opt, iters: int = 4):
    """The flow stage's step: one update of `model` by `opt` on a batch
    (img1, img2, flow, valid) on the model's device. Returns dict(loss,
    epe, gnorm) as 0-dim tensors (gnorm before the clip)."""

    def train_step(img1, img2, flow_gt, valid):
        opt.zero_grad()
        loss, epe = flow_loss(model, img1, img2, flow_gt, valid, iters)
        loss.backward()
        gnorm = opt.step()
        return dict(loss=loss.detach(), epe=epe.detach(), gnorm=gnorm)

    return train_step


class _Prefetcher:
    """Host-side batch producer: overlaps procedural scene rendering
    (numpy, seconds per batch at 240x320) with the device step. Workers
    draw a geometry bucket per batch; the consumer pops ready batches.
    Determinism: each worker seeds from (seed, worker_id) — batch order
    is not reproducible across thread schedules, acceptable for this
    self-training use (the reference's torch DataLoader workers have the
    same property). Batches stay on the host; the consumer uploads."""

    def __init__(self, make_fn, buckets, seed, batch, n_workers=2, depth=4):
        import queue
        import threading
        self.q = queue.Queue(maxsize=depth)
        self.stop = threading.Event()

        def work(wid):
            rng = np.random.RandomState((seed * 97 + wid) % (1 << 31))
            while not self.stop.is_set():
                Hb, Wb, fxb = buckets[rng.randint(len(buckets))]
                item = make_fn(rng, batch, Hb, Wb, fxb)
                while not self.stop.is_set():
                    try:
                        self.q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        self.threads = [threading.Thread(target=work, args=(w,), daemon=True)
                        for w in range(n_workers)]
        for t in self.threads:
            t.start()

    def get(self):
        return self.q.get()

    def close(self):
        self.stop.set()
        # drain so producers blocked on put() can observe stop
        try:
            while True:
                self.q.get_nowait()
        except Exception:
            pass
        for t in self.threads:
            t.join(timeout=30.0)


# Geometry buckets for training: the tracker must be accurate at the
# resolutions the SLAM actually runs (240x320 @ fx~200 for the Synthetic
# bench, 340x600 @ fx~580 downscaled for Replica ~ similar 1/8-res flow
# stats). Training only at 96x128/fx<=144 left the net with a ~0.45 px EPE
# floor at bench geometry — flows there are 2-3x larger than anything it
# saw.
FLOW_BUCKETS = ((96, 128, 80.0), (240, 320, 200.0))


class _Pool:
    """Pre-rendered batch pool: render `n_batches` (buckets in turn) ONCE,
    then cycle them shuffled. Fresh per-step rendering costs seconds of
    host time per batch against a device step of tens of milliseconds, and
    the renderer threads share the interpreter lock with the training
    loop, so a pool makes training device-bound. The procedural scene
    family is diverse (random seed/fx/motion per batch), so reuse across
    epochs behaves like ordinary multi-epoch training. `render_s` is the
    host time the pool took to render."""

    def __init__(self, make_fn, buckets, seed, batch, n_batches,
                 log_every=20):
        t0 = time.perf_counter()
        rng = np.random.RandomState(seed)
        self.items = []
        for i in range(n_batches):
            Hb, Wb, fxb = buckets[i % len(buckets)]
            self.items.append(make_fn(rng, batch, Hb, Wb, fxb))
            if i % log_every == 0:
                print(f"pool render {i}/{n_batches}", flush=True)
        self.render_s = time.perf_counter() - t0
        self.rng = rng
        self.order = []

    def get(self):
        if not self.order:
            self.order = list(self.rng.permutation(len(self.items)))
        return self.items[self.order.pop()]

    def close(self):
        pass


def _save(model, ckpt_path):
    if not ckpt_path:
        return
    os.makedirs(os.path.dirname(ckpt_path) or ".", exist_ok=True)
    save_droid_params(model, ckpt_path)
    print(f"saved {ckpt_path}", flush=True)


def _run(step_fn, pre, steps, device, log_every, ckpt_every, ckpt_path,
         model, line, records):
    """The loop both stages share: pop a host batch, upload it, step, print
    every `log_every` steps, checkpoint every `ckpt_every`. `records`, when
    a dict, gets "pool_render_s" (the pool's host render time, None for the
    prefetcher) and "steps", one dict per step (image shape, milliseconds
    to the end of the step on the device, metrics), at the cost of a
    synchronisation per step."""
    history = []
    if records is not None:
        records["pool_render_s"] = getattr(pre, "render_s", None)
        records["steps"] = []
    try:
        for step in range(steps):
            batch = [t.to(device) for t in pre.get()]
            t0 = time.perf_counter()
            m = step_fn(*batch)
            if records is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                records["steps"].append(dict(
                    step=step, shape=tuple(batch[0].shape[-3:-1]),
                    ms=(time.perf_counter() - t0) * 1e3,
                    **{k: float(v) for k, v in m.items()}))
            if step % log_every == 0 or step == steps - 1:
                history.append(line(step, m, batch[0].shape[-3:-1]))
            if step and step % ckpt_every == 0:
                # periodic checkpoint: a killed long run keeps its progress
                _save(model, ckpt_path)
    finally:
        pre.close()
    _save(model, ckpt_path)
    return history


def train(steps=2000, batch=4, H=96, W=128, lr=2e-4, seed=0,
          ckpt_path="pretrained/droid_selftrained.msgpack", log_every=25,
          params=None, buckets=None, iters=8, pool=0, device=None,
          records=None):
    """Flow stage: train and save the net (flax serialisation msgpack).

    params: a trainable DroidNet to continue from (None: init_params from
    `seed`). pool > 0: pre-render that many batches (cycled shuffled)
    instead of streaming fresh batches through the prefetcher — see _Pool.
    device None is the GPU (resolve_device). records: a dict to fill with
    per-step times and metrics (see _run). Returns (model, history of the
    logged EPEs)."""
    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed),
                             device=device)
    model = params.to(device)
    opt = make_optimizer(model, lr, steps)
    step_fn = make_train_step(model, opt, iters=iters)
    if buckets is None:
        buckets = [(H, W, 80.0)]
    if pool:
        pre = _Pool(make_pair_batch, buckets, seed, batch, pool)
    else:
        pre = _Prefetcher(make_pair_batch, buckets, seed, batch)

    def line(step, m, hw):
        print(f"step {step}: loss {float(m['loss']):.4f} "
              f"epe {float(m['epe']):.3f} px ({hw[0]}x{hw[1]}) "
              f"gnorm {float(m['gnorm']):.2f}", flush=True)
        return float(m["epe"])

    history = _run(step_fn, pre, steps, device, log_every, 500, ckpt_path,
                   model, line, records)
    return model, history


# ---------------------------------------------------------------------------
# Stage 2: training THROUGH the differentiable BA layer (DROID's actual
# training signal — pose/depth supervision after the solver). Flow-only
# pretraining (above) gives a tracker whose weight/damping heads have never
# seen how the solver uses them.
# ---------------------------------------------------------------------------

def seq_edges(N: int, r: int = 2):
    """Neighborhood edge set over an N-frame training sequence (both
    directions, |i-j| <= r — the frontend's add_neighborhood_factors)."""
    ii, jj = [], []
    for i in range(N):
        for j in range(N):
            if i != j and abs(i - j) <= r:
                ii.append(i)
                jj.append(j)
    return np.asarray(ii, np.int32), np.asarray(jj, np.int32)


def make_seq_batch(rng: np.random.RandomState, batch: int, N: int,
                   H: int, W: int, fx: float = 80.0):
    """`batch` synthetic N-frame sequences with GT w2c poses + 1/8 disps, as
    CPU tensors: imgs (B,N,H,W,3), disps (B,N,h,w), poses (B,N,7), intr8
    (B,4). Same draws from `rng` as the JAX package. The trajectory start
    is random (windows fixed at frame 0 share one sin-phase) and the frame
    stride is 1-3: production sequences are keyframes (median admission
    gap ~2 on the bench scene)."""
    h, w = H // 8, W // 8
    imgs_b, disps_b, poses_b, intr_b = [], [], [], []
    for _ in range(batch):
        fx_s = float(fx * (0.7 + 1.8 * rng.rand()))
        k0 = int(rng.randint(0, 60))
        stride = int(1 + rng.randint(3))
        ds = _synthetic(H, W, fx_s, {
            "n_frames": k0 + (N - 1) * stride + 1,
            "seed": int(rng.randint(1 << 30)),
            "motion_scale": float(0.5 + 9.5 * rng.rand())})
        imgs, disps, poses = [], [], []
        for k in range(N):
            _, im, d, c2w = ds[k0 + k * stride]
            imgs.append(im)
            disps.append(_disp8(d, h, w))
            poses.append(_w2c(c2w))
        imgs_b.append(np.stack(imgs))
        disps_b.append(np.stack(disps).astype(np.float32))
        poses_b.append(torch.stack(poses))
        intr_b.append([fx_s / 8, fx_s / 8, (W / 2 - 0.5) / 8,
                       (H / 2 - 0.5) / 8])
    return (torch.as_tensor(np.stack(imgs_b)),
            torch.as_tensor(np.stack(disps_b)), torch.stack(poses_b),
            torch.as_tensor(np.asarray(intr_b, np.float32)))


def dba_scene_loss(model, imgs, disps_gt, poses_gt, intr8, N: int = 7,
                   iters: int = 8, gamma: float = 0.9, w_pose: float = 10.0,
                   w_disp: float = 0.05, w_flow: float = 0.05):
    """The DBA stage's loss on ONE scene: (loss, ate), scalars carrying the
    graph. imgs (N,H,W,3); disps_gt (N,h,w); poses_gt (N,7) w2c; intr8 (4,).

    Protocol (DROID-SLAM training): poses start at GT frame 0 (gauge fixed
    by freezing pose 0, t0 = 1), disparities at 1; each round runs the
    learned update then two Gauss-Newton iterations of the differentiable
    solver, so pose/depth gradients flow back into the delta/weight/eta
    heads. Supervision after every round: geodesic pose error, disparity
    L1 (pins the monocular scale) and flow-to-GT L1 on the round's
    target."""
    dev = imgs.device
    ii_np, jj_np = seq_edges(N)
    edges = make_edges(ii_np, jj_np, t0=1, t1=N, device=dev)
    ii, jj = edges.ii, edges.jj
    uniq, inv = np.unique(ii_np, return_inverse=True)
    ix = torch.as_tensor(inv.astype(np.int64), device=dev)
    Mk = len(uniq)   # == N for a neighborhood graph
    E = len(ii_np)

    h, w = disps_gt.shape[-2:]
    coords0 = pops.coords_grid(h, w, device=dev)
    x = normalize_images(imgs)
    fmaps = model.features(x)
    cn, ci = model.context(x)
    pyr = corr_ops.build_fmap_pyramid(fmaps.float(), 4)

    intr_t = intr8.expand(N, 4)
    flow_gt, valid_gt = pops.projective_transform(
        poses_gt[None], disps_gt[None], intr_t[None], ii, jj)
    flow_gt, valid_gt = flow_gt[0], valid_gt[0][..., 0]

    poses = poses_gt[0].expand(N, 7)
    disps = torch.ones(N, h, w, device=dev)
    net = cn[ii]
    inp = ci[ii]
    target = coords0.expand(E, h, w, 2)
    zeros_sens = torch.zeros_like(disps)

    def round_body(poses, disps, net, target):
        coords1, _ = pops.projective_transform(
            poses[None], disps[None], intr_t[None], ii, jj)
        coords1 = coords1[0]
        corr = corr_ops.alt_corr(pyr, ii, jj, coords1)
        motn = _clip(torch.cat([coords1 - coords0, target - coords1], -1),
                     -64.0, 64.0)
        net, delta, weight = model.update_step(net, inp, corr,
                                               motn.permute(0, 3, 1, 2))
        target = coords1 + delta.permute(0, 2, 3, 1).float()
        eta_agg, _ = model.update_agg(net, ix, Mk)
        eta = 0.2 * eta_agg[edges.kx] + 1e-7
        poses, disps = dba(poses, disps, intr8, target,
                           weight.permute(0, 2, 3, 1).float(), eta,
                           zeros_sens, edges, iters=2)
        return poses, disps, net, target

    total = 0.0
    for k in range(iters):
        # rematerialise each round: the unrolled graph of `iters` GRU+Schur
        # rounds would otherwise hold every intermediate
        poses, disps, net, target = checkpoint(
            round_body, poses, disps, net, target, use_reentrant=False)
        # geodesic pose error on the optimised frames
        derr = lie.log(lie.mul(poses[1:], lie.inv(poses_gt[1:])))
        pose_err = _abs(derr).mean()
        disp_err = _abs(disps - disps_gt).mean()
        flow_err = (_abs(target - flow_gt) * valid_gt[..., None]).mean()
        g = gamma ** (iters - k - 1)
        total = total + g * (w_pose * pose_err + w_disp * disp_err
                             + w_flow * flow_err)
    ate = torch.linalg.norm(
        lie.to_matrix(lie.inv(poses))[:, :3, 3]
        - lie.to_matrix(lie.inv(poses_gt))[:, :3, 3], dim=-1).mean()
    return total, ate


def make_dba_train_step(model, opt, N: int = 7, iters: int = 8,
                        gamma: float = 0.9, w_pose: float = 10.0,
                        w_disp: float = 0.05, w_flow: float = 0.05):
    """The DBA stage's step: one update of `model` by `opt` on a batch
    (imgs, disps_gt, poses_gt, intr8) of B scenes. The loss is the mean of
    the scenes' (dba_scene_loss); each scene is back-propagated on its own.
    Returns dict(loss, ate, gnorm) as 0-dim tensors."""

    def train_step(imgs, disps_gt, poses_gt, intr8):
        opt.zero_grad()
        B = imgs.shape[0]
        loss = ate = 0.0
        for b in range(B):
            ls, at = dba_scene_loss(model, imgs[b], disps_gt[b], poses_gt[b],
                                    intr8[b], N, iters, gamma, w_pose,
                                    w_disp, w_flow)
            (ls / B).backward()
            loss = loss + ls.detach() / B
            ate = ate + at.detach() / B
        gnorm = opt.step()
        return dict(loss=loss, ate=ate, gnorm=gnorm)

    return train_step


def train_dba(steps=1500, batch=2, N=7, H=96, W=128, iters=8, lr=5e-5,
              seed=1, init_ckpt="pretrained/droid_selftrained.msgpack",
              ckpt_path="pretrained/droid_dba.msgpack",
              log_every=20, params=None, buckets=None, pool=0, device=None,
              records=None):
    """Fine-tune the update operator through the BA layer.

    Starts from the flow-pretrained checkpoint (stage 1) when present —
    cold-starting BA-unrolled training with random heads makes the solver
    chase noise. device None is the GPU; records as in `train`. Returns
    (model, history of the logged ATEs)."""
    device = resolve_device(device)
    if params is None:
        if init_ckpt and os.path.exists(init_ckpt):
            params = load_selftrained(init_ckpt, device=device)
            print(f"init from {init_ckpt}")
        else:
            params = init_params(torch.Generator().manual_seed(seed),
                                 device=device)
    model = params.to(device)
    # global-norm clip, not the reference's per-element 0.01 zeroing —
    # see make_optimizer
    opt = make_optimizer(model, lr, steps)
    step_fn = make_dba_train_step(model, opt, N=N, iters=iters)
    if buckets is None:
        buckets = [(H, W, 80.0)]

    def mk(r, b, Hb, Wb, fxb):
        return make_seq_batch(r, b, N, Hb, Wb, fx=fxb)

    if pool:
        pre = _Pool(mk, buckets, seed, batch, pool)
    else:
        pre = _Prefetcher(mk, buckets, seed, batch)

    def line(step, m, hw):
        print(f"step {step}: loss {float(m['loss']):.4f} "
              f"ate {float(m['ate']):.4f} ({hw[0]}x{hw[1]}) "
              f"gnorm {float(m['gnorm']):.2f}", flush=True)
        return float(m["ate"])

    history = _run(step_fn, pre, steps, device, log_every, 200, ckpt_path,
                   model, line, records)
    return model, history
