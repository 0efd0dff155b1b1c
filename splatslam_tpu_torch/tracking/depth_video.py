"""DepthVideo — the keyframe buffer (counterpart of
splatslam_tpu/tracking/depth_video.py).

Per-keyframe state lives in fixed-capacity tensors on the run's device
(`VideoState`, buffer dimension first); the keyframe counter and dirty
flags are host-side, since they drive control flow.

Layout: geometric fields are channel-last as in the JAX package (disps
(B,h,w), flow targets (E,h,w,2)); the tracking network's per-keyframe
fields — correlation features `fmaps` (bf16 always, as in the JAX package),
GRU seeds `nets` and context `inps` — are channel-first (B,128,h,w), the
layout the network's convolutions take, so no edge gather ever permutes
them. `convert.video_state_from_numpy` permutes a JAX state across.

Geometric kernels of the reference CUDA ops, in plain PyTorch:
  * frame_distance — droid_kernels.cu frame_distance (flow-distance metric)
  * depth_filter   — droid_kernels.cu depth_filter (multiview consistency)
  * reproject      — projective_transform of frames ii into frames jj
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops import lie, projective as pops, ba as ba_ops
from ..ops.upsample import upsample_disp, upsample_disp_uniform
from ..utils.profiling import tally

# the CUDA kernels use 0.25 (droid_kernels.cu:26); python ops use 0.2
CUDA_MIN_DEPTH = 0.25


@dataclasses.dataclass
class VideoState:
    """Fixed-capacity per-keyframe state (buffer dim first); field names
    follow the JAX VideoState."""
    timestamp: torch.Tensor      # (B,) f32
    images: torch.Tensor         # (B, H, W, 3) uint8
    poses: torch.Tensor          # (B, 7) f32 — world-to-camera SE3
    disps: torch.Tensor          # (B, h, w) f32 — 1/8-res disparity
    disps_up: torch.Tensor       # (B, H, W) f32
    intrinsics: torch.Tensor     # (B, 4) f32 — at 1/8 resolution
    mono_disps: torch.Tensor     # (B, h, w) f32
    depth_scale: torch.Tensor    # (B,) f32
    depth_shift: torch.Tensor    # (B,) f32
    valid_depth_mask: torch.Tensor        # (B, H, W) bool
    valid_depth_mask_small: torch.Tensor  # (B, h, w) bool
    fmaps: torch.Tensor          # (B, 128, h, w) bf16 — correlation features
    nets: torch.Tensor           # (B, 128, h, w) f32 — GRU hidden seed
    inps: torch.Tensor           # (B, 128, h, w) f32 — context features
    gt_poses: torch.Tensor       # (B, 7) f32 — GT w2c (oracle/eval only)
    gt_disps: torch.Tensor       # (B, h, w) f32 — GT disparity (oracle)


def make_video_state(buffer: int, H: int, W: int, down: int = 8,
                     device=None) -> VideoState:
    """Empty keyframe buffer; `device` None is the GPU (resolve_device)."""
    device = resolve_device(device)
    h, w = H // down, W // down
    f32 = dict(dtype=torch.float32, device=device)
    return VideoState(
        timestamp=torch.zeros(buffer, **f32),
        images=torch.zeros((buffer, H, W, 3), dtype=torch.uint8,
                           device=device),
        poses=lie.identity((buffer,), device=device),
        disps=torch.ones((buffer, h, w), **f32),
        disps_up=torch.zeros((buffer, H, W), **f32),
        intrinsics=torch.zeros((buffer, 4), **f32),
        mono_disps=torch.zeros((buffer, h, w), **f32),
        depth_scale=torch.zeros(buffer, **f32),
        depth_shift=torch.zeros(buffer, **f32),
        valid_depth_mask=torch.zeros((buffer, H, W), dtype=torch.bool,
                                     device=device),
        valid_depth_mask_small=torch.zeros((buffer, h, w), dtype=torch.bool,
                                           device=device),
        fmaps=torch.zeros((buffer, 128, h, w), dtype=torch.bfloat16,
                          device=device),
        nets=torch.zeros((buffer, 128, h, w), **f32),
        inps=torch.zeros((buffer, 128, h, w), **f32),
        gt_poses=lie.identity((buffer,), device=device),
        gt_disps=torch.ones((buffer, h, w), **f32))


# ---------------------------------------------------------------------------
# geometric kernels
# ---------------------------------------------------------------------------

def frame_distance(poses, disps, intrinsics, ii, jj, beta):
    """Mean induced-flow distance: mean over valid pixels of
    β·‖flow(SE3)‖ + (1−β)·‖flow(t only)‖; 1000 when fewer than 75% of the
    pixels are valid. poses (B,7), disps (B,h,w), intrinsics (4,),
    ii/jj (N,) → (N,)."""
    h, w = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(0)
    grid = pops.coords_grid(h, w, device=disps.device)
    d_i = disps[ii]
    X = (grid[..., 0] - cx) / fx
    Y = (grid[..., 1] - cy) / fy
    ones = torch.ones_like(d_i)
    Xi = torch.stack([X * ones, Y * ones, ones, d_i], -1)
    Gij = lie.mul(poses[jj], lie.inv(poses[ii]))
    Xj_full = lie.act(Gij[:, None, None], Xi)
    Xj_t = torch.cat([Xi[..., :3] + Xi[..., 3:4] * Gij[:, None, None, :3],
                      Xi[..., 3:4]], -1)

    def flow_mag(Xj):
        u = fx * Xj[..., 0] / Xj[..., 2] + cx
        v = fy * Xj[..., 1] / Xj[..., 2] + cy
        d = torch.sqrt((u - grid[..., 0]) ** 2 + (v - grid[..., 1]) ** 2)
        return d, Xj[..., 2] > CUDA_MIN_DEPTH

    d1, v1 = flow_mag(Xj_full)
    d2, v2 = flow_mag(Xj_t)
    accum = (beta * (d1 * v1).sum((-2, -1))
             + (1 - beta) * (d2 * v2).sum((-2, -1)))
    valid = beta * v1.sum((-2, -1)) + (1 - beta) * v2.sum((-2, -1))
    frac = valid / (float(h * w) + 1e-8)
    return torch.where(frac < 0.75, torch.full_like(accum, 1000.0),
                       accum / torch.clamp(valid, min=1e-8))


def depth_filter(poses, disps, intrinsics, inds, thresh):
    """Multiview consistency counter: for each frame ix in `inds` and each
    neighbour jx ∈ {ix−1, ix−2, ix−3, ix+3, ix+4, ix+5}, count whether the
    reprojected inverse depth agrees with any of the 4 integer-neighbour
    disparities within thresh. Returns (len(inds), h, w) float counts."""
    num, h, w = disps.shape
    fx, fy, cx, cy = intrinsics.unbind(0)
    grid = pops.coords_grid(h, w, device=disps.device)
    X = (grid[..., 0] - cx) / fx
    Y = (grid[..., 1] - cy) / fy
    d_i = disps[inds]                                        # (n,h,w)
    ones = torch.ones_like(d_i)
    Xi = torch.stack([X * ones, Y * ones, ones, d_i], -1)
    counts = torch.zeros_like(d_i)
    t = thresh[:, None, None]
    for off in (-1, -2, -3, 3, 4, 5):
        jx = inds + off
        valid_j = (jx >= 0) & (jx < num)
        jx_c = torch.clamp(jx, 0, num - 1)
        Gij = lie.mul(poses[jx_c], lie.inv(poses[inds]))
        Xj = lie.act(Gij[:, None, None], Xi)
        uj = fx * Xj[..., 0] / Xj[..., 2] + cx
        vj = fy * Xj[..., 1] / Xj[..., 2] + cy
        dj = Xj[..., 3] / Xj[..., 2]
        u0 = torch.floor(uj)
        v0 = torch.floor(vj)
        inb = (u0 >= 0) & (v0 >= 0) & (u0 < w - 1) & (v0 < h - 1)
        u0c = torch.clamp(u0, 0, w - 2).long()
        v0c = torch.clamp(v0, 0, h - 2).long()
        dmap = disps[jx_c]
        b = torch.arange(len(inds), device=disps.device)[:, None, None]
        agree = torch.zeros_like(inb)
        for dv in (0, 1):
            for du in (0, 1):
                dn = dmap[b, v0c + dv, u0c + du]
                agree = agree | ((1.0 / dj - 1.0 / dn).abs() < t)
        counts = counts + (agree & inb & valid_j[:, None, None]).float()
    return counts


def nanmedian(x, dim=-1):
    """Median ignoring NaN, the mean of the two middle values for an even
    count (numpy/JAX nanmedian; torch.nanmedian takes the lower one)."""
    s = torch.sort(x, dim=dim).values              # NaN sorts last
    n = (~torch.isnan(x)).sum(dim, keepdim=True)
    lo = torch.gather(s, dim, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(s, dim, torch.clamp(n // 2, max=x.shape[dim] - 1))
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.full_like(med, float("nan"))
                       ).squeeze(dim)


def valid_depth_masks(poses, disps_full, intr, idx, thresh_mult,
                      visible_num):
    """Multiview-filter masks for frames idx: multiview-consistent pixels
    closer than 3× the frame's consistent-depth median."""
    disps = disps_full[idx]
    depths = 1.0 / torch.clamp(disps, min=1e-8)
    thresh = thresh_mult * depths.mean(dim=(1, 2))
    count = depth_filter(poses, disps_full, intr, idx, thresh)
    multiview = count >= visible_num
    depths_mv = torch.where(multiview, depths,
                            torch.full_like(depths, float("nan")))
    med = nanmedian(depths_mv.reshape(len(idx), -1))
    return multiview & (depths < 3 * med[:, None, None])


def reproject(poses, disps, intrinsics, ii, jj):
    """Pixels of frames ii projected into frames jj: (coords (N,h,w,2),
    valid (N,h,w,1))."""
    intr = intrinsics.expand(poses.shape[0], 4)
    coords, valid = pops.projective_transform(
        poses[None], disps[None], intr[None], ii, jj)
    return coords[0], valid[0]


def normalize_video(poses, disps, count_mask):
    """Rescale disparities of active frames to unit mean and translations
    to match. count_mask (B,) 1.0 for active frames."""
    s = ((disps * count_mask[:, None, None]).sum()
         / torch.clamp(count_mask.sum() * disps.shape[1] * disps.shape[2],
                       min=1.0))
    act = count_mask > 0
    disps = torch.where(act[:, None, None], disps / s, disps)
    poses = torch.cat([torch.where(act[:, None], poses[:, :3] * s,
                                   poses[:, :3]), poses[:, 3:]], 1)
    return poses, disps


def _disp8(full, down, h, w):
    """1/8 subsample of a full-res depth map → disparity (0 on holes)."""
    off = down // 2 - 1
    d = full[off::down, off::down][:h, :w]
    return torch.where(d > 1e-6, 1.0 / torch.clamp(d, min=1e-6),
                       torch.zeros_like(d))


class DepthVideo:
    """Host facade over VideoState, mirroring the reference API.

    `flops_tracking` / `flops_mapping` are the achieved-FLOP accounting of
    the JAX package (depth_video.py:295-299): host arithmetic only, no
    device work and no sync, that the tracker's and the mapper's producers
    add to with the JAX coefficients unchanged; a bench divides their sum
    by the run's wall. Counting rule: the JAX package counts what its
    device computes, padding included ("the padded pair count is what the
    kernel actually computes", depth_video.py:394-396). This port pads
    nothing — its edge sets, BA plans, admission chunks and camera batches
    have exact sizes — so it counts its own exact sizes with the same
    coefficients, and each frame distance once (it has no speculative
    `distance_async` whose discarded result the JAX package counts a
    second time). On the same run the port's totals are therefore at most
    the JAX package's."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.H = cfg["cam"]["H_out"]
        self.W = cfg["cam"]["W_out"]
        self.down = 8
        self.buffer = cfg["tracking"]["buffer"]
        self.BA_type = cfg["tracking"]["backend"]["BA_type"]
        self.mono_thres = cfg["tracking"]["mono_thres"]
        self.state = make_video_state(self.buffer, self.H, self.W, self.down,
                                      self.device)
        self.counter = 0
        self.dirty = np.zeros(self.buffer, bool)
        self.npc_dirty = np.zeros(self.buffer, bool)
        self.flops_tracking = 0.0
        self.flops_mapping = 0.0

    @property
    def intr0(self):
        """Shared 1/8-res intrinsics (every keyframe has the same)."""
        return self.state.intrinsics[0]

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # -- item access ------------------------------------------------------

    def append(self, timestamp, image, pose, disp, mono_depth, intrinsics,
               fmap=None, net=None, inp=None, gt_pose=None, gt_depth=None):
        """Add a keyframe (depth_video.py:75-134 semantics)."""
        idx = self.counter
        self.set_item(idx, timestamp, image, pose, disp, mono_depth,
                      intrinsics, fmap, net, inp, gt_pose, gt_depth)
        self.counter = idx + 1

    @torch.no_grad()
    def set_item(self, idx, timestamp, image, pose=None, disp=None,
                 mono_depth=None, intrinsics=None, fmap=None, net=None,
                 inp=None, gt_pose=None, gt_depth=None):
        """Write one keyframe's given fields. mono_depth/gt_depth are
        full-res depth (or already 1/8-res disparity); stored as 1/8-res
        disparity. fmap/net/inp are (128,h,w) tensors; fmap is stored in
        bf16."""
        s = self.state
        s.timestamp[idx] = float(timestamp)
        h, w = s.disps.shape[1:]

        def disp_of(v):
            v = self._t(v)
            return v if tuple(v.shape) == (h, w) else _disp8(v, self.down,
                                                              h, w)

        if image is not None:
            s.images[idx] = image.to(self.device) if torch.is_tensor(image) \
                else self._t(image, torch.uint8)
        if pose is not None:
            s.poses[idx] = self._t(pose)
        if disp is not None:
            s.disps[idx] = self._t(disp)
        if mono_depth is not None:
            s.mono_disps[idx] = disp_of(mono_depth)
        if intrinsics is not None:
            s.intrinsics[idx] = self._t(intrinsics)
        for field, v in ((s.fmaps, fmap), (s.nets, net), (s.inps, inp)):
            if v is not None:
                field[idx] = v.to(field.dtype)
        if gt_pose is not None:
            s.gt_poses[idx] = self._t(gt_pose)
        if gt_depth is not None:
            s.gt_disps[idx] = disp_of(gt_depth)
        if idx >= self.counter:
            self.counter = idx + 1

    # -- geometry ----------------------------------------------------------

    def _idx(self, ix):
        return torch.as_tensor(np.asarray(ix, np.int64).reshape(-1),
                               device=self.device)

    @torch.no_grad()
    def reproject(self, ii, jj):
        return reproject(self.state.poses, self.state.disps, self.intr0,
                         self._idx(ii), self._idx(jj))

    @torch.no_grad()
    def distance(self, ii, jj, beta=0.3, bidirectional=False):
        """Frame distance (depth_video.py:180-210); host numpy result."""
        ii_t, jj_t = self._idx(ii), self._idx(jj)
        # JAX depth_video.py:397-400: every pixel of a pair reprojected
        # twice (pose-induced and translation-only flow) ≈ 2×600 F
        px = (self.H // self.down) * (self.W // self.down)
        self.flops_tracking += ((2 if bidirectional else 1)
                                * ii_t.shape[0] * px * 1.2e3)
        s = self.state
        d = frame_distance(s.poses, s.disps, self.intr0, ii_t, jj_t, beta)
        if bidirectional:
            d = 0.5 * (d + frame_distance(s.poses, s.disps, self.intr0,
                                          jj_t, ii_t, beta))
        return d.cpu().numpy()

    @torch.no_grad()
    def upsample(self, ix, upmask=None):
        """8× upsampling of frames ix: convex with the network's mask
        (len(ix),576,h,w), uniform (zero mask) when upmask is None (oracle
        path)."""
        ix = self._idx(ix)
        d = self.state.disps[ix]
        self.state.disps_up[ix] = upsample_disp_uniform(d) if upmask is None \
            else upsample_disp(d, upmask.float().permute(0, 2, 3, 1))

    def get_nets(self, ii):
        """GRU hidden seeds of the source keyframes of edges ii."""
        return self.state.nets[self._idx(ii)]

    @torch.no_grad()
    def normalize(self):
        mask = (torch.arange(self.buffer, device=self.device)
                < self.counter).float()
        self.state.poses, self.state.disps = normalize_video(
            self.state.poses, self.state.disps, mask)
        self.set_dirty(0, self.counter)

    # -- BA dispatch (DSPO layer, depth_video.py:212-312) -------------------

    def ba(self, target, weight, eta, ii, jj, t0=1, t1=None, iters=2,
           lm=1e-4, ep=0.1, motion_only=False, opt_type="pose_depth"):
        if self.BA_type == "DSPO":
            if not self.dspo(target, weight, eta, ii, jj, t0, t1, iters, lm,
                             ep, motion_only, opt_type):
                self.dspo(target, weight, eta, ii, jj, t0, t1, iters, lm,
                          ep, motion_only, "pose_depth")
        elif self.BA_type == "DBA":
            self.dspo(target, weight, eta, ii, jj, t0, t1, iters, lm, ep,
                      motion_only, "pose_depth")
        else:
            raise NotImplementedError(self.BA_type)

    @torch.no_grad()
    def dspo(self, target, weight, eta, ii, jj, t0=1, t1=None, iters=2,
             lm=1e-4, ep=0.1, motion_only=False, opt_type="pose_depth"):
        """DSPO layer: stage-1 pose+depth / stage-2 depth+scale+shift.
        eta (len(unique(ii)), h, w) rows for unique(ii), or None."""
        ii_np = np.asarray(ii, np.int64).reshape(-1)
        jj_np = np.asarray(jj, np.int64).reshape(-1)
        if t1 is None:
            t1 = int(max(ii_np.max(), jj_np.max())) + 1
        s = self.state
        target = torch.as_tensor(target, device=self.device)
        weight = torch.as_tensor(weight, device=self.device)

        def eta_rows(edges):
            h, w = s.disps.shape[-2:]
            out = torch.zeros((edges.M, h, w), device=self.device)
            if eta is not None:
                uniq = np.unique(ii_np)
                lut = {int(f): r for r, f in enumerate(uniq)}
                rows = np.asarray([lut.get(int(f), -1)
                                   for f in edges.kx.cpu().numpy()])
                sel = np.where(rows >= 0)[0]
                out[self._idx(sel)] = torch.as_tensor(
                    eta, device=self.device)[self._idx(rows[sel])]
            return out

        if opt_type == "pose_depth":
            edges = ba_ops.make_edges(ii_np, jj_np, int(t0), int(t1),
                                      self.device)
            s.poses, s.disps = ba_ops.dba(
                s.poses, s.disps, self.intr0, target, weight,
                eta_rows(edges), torch.zeros_like(s.disps), edges,
                iters=iters, lm=lm, ep=ep, motion_only=motion_only)
            return True

        if opt_type == "depth_scale":
            self.update_valid_depth_mask(up=False)
            curr = self.counter
            sc, sh, err = ba_ops.align_scale_and_shift(
                s.mono_disps[:curr], s.disps[:curr],
                s.valid_depth_mask_small[:curr])
            s.depth_scale[:curr] = sc
            s.depth_shift[:curr] = sh
            keep = np.ones(len(ii_np), bool)
            if self.mono_thres:
                bad = ba_ops.bad_mono_from_fit(
                    sc, err, s.disps[:curr], s.valid_depth_mask_small[:curr],
                    float(self.mono_thres)).cpu().numpy()
                bad_frames = set(np.where(bad)[0].tolist())
                depth_frames = np.unique(ii_np)
                tally("n.dspo.bad_mono", int(bad[depth_frames].sum()))
                tally("n.dspo.frames", len(depth_frames))
                keep = np.asarray([(int(a) not in bad_frames)
                                   and (int(b) not in bad_frames)
                                   for a, b in zip(ii_np, jj_np)], bool)
                if keep.sum() == 0:
                    return False
            if curr <= 0 or keep.sum() == 0:
                return False
            sel = self._idx(np.where(keep)[0])
            edges = ba_ops.make_edges(ii_np[keep], jj_np[keep], int(t0),
                                      int(t1), self.device)
            s.disps, s.depth_scale, s.depth_shift = ba_ops.ba_scale_shift(
                s.poses, s.disps, self.intr0, target[sel], weight[sel],
                eta_rows(edges), s.mono_disps, s.depth_scale, s.depth_shift,
                s.valid_depth_mask_small, edges, iters=iters, lm=lm, ep=ep,
                alpha=0.01)
            return True

        raise NotImplementedError(opt_type)

    # -- multiview filter (depth_video.py:340-375) --------------------------

    @torch.no_grad()
    def update_valid_depth_mask(self, up=True):
        if up:
            dirty_index = np.where(self.dirty)[0]
        else:
            dirty_index = np.arange(self.counter)
        if len(dirty_index) == 0:
            return
        s = self.state
        idx = self._idx(dirty_index)
        mv = self.cfg["tracking"]["multiview_filter"]
        masks = valid_depth_masks(
            s.poses, s.disps_up if up else s.disps,
            self.intr0 * float(self.down if up else 1.0), idx,
            float(mv["thresh"]), int(mv["visible_num"]))
        if up:
            s.valid_depth_mask[idx] = masks
            self.dirty[dirty_index] = False
        else:
            s.valid_depth_mask_small[idx] = masks

    def set_dirty(self, start, end):
        self.dirty[start:end] = True
        self.npc_dirty[start:end] = True

    # -- export (depth_video.py:327-398) ------------------------------------

    def get_pose(self, index):
        """c2w 4x4 matrix (numpy) of keyframe `index`."""
        return lie.inv_matrix_np(self.state.poses[index].cpu().numpy())[0]

    def get_depth_and_pose(self, index):
        """(depth (H,W), valid mask (H,W), c2w 4x4), numpy."""
        est_disp = self.state.disps_up[index]
        est_depth = (1.0 / torch.clamp(est_disp, min=1e-8)).cpu().numpy()
        mask = self.state.valid_depth_mask[index].cpu().numpy()
        return est_depth, mask, self.get_pose(index)

    @torch.no_grad()
    def get_depth_scale_and_shift(self, index, mono_depth, est_depth,
                                  weights):
        """Fit and store keyframe `index`'s mono-prior scale and shift;
        returns [scale, shift]."""
        t = lambda x: torch.as_tensor(
            x if torch.is_tensor(x) else np.asarray(x),
            dtype=torch.float32, device=self.device)[None]
        scale, shift, _ = ba_ops.align_scale_and_shift(
            t(mono_depth), t(est_depth), t(weights))
        self.state.depth_scale[index] = scale[0]
        self.state.depth_shift[index] = shift[0]
        return [float(scale[0]), float(shift[0])]

    def save_video(self, path: str):
        n = self.counter
        s = self.state
        disps = s.disps_up[:n].cpu().numpy()
        depths = 1.0 / np.clip(disps, 1e-8, None)
        poses7 = s.poses[:n].cpu().numpy()
        poses = lie.inv_matrix_np(poses7) if n else \
            np.zeros((0, 4, 4), np.float32)
        np.savez(path, poses=poses, depths=depths,
                 timestamps=s.timestamp[:n].cpu().numpy(),
                 valid_depth_masks=s.valid_depth_mask[:n].cpu().numpy())

    def eval_depth_l1(self, npz_path, stream, global_scale=None):
        """Proxy-depth L1 vs GT (depth_video.py:401-448): (L1, L1 where
        GT < 4 m, mean mask coverage)."""
        data = np.load(npz_path)
        stamps = data["timestamps"]
        n = stamps.shape[0]
        masks_all = self.state.valid_depth_mask[:n].cpu().numpy()
        disps_all = self.state.disps_up[:n].cpu().numpy()

        def _align_np(pred, target, w):
            a00 = (w * pred * pred).sum()
            a01 = (w * pred).sum()
            a11 = w.sum()
            b0 = (w * pred * target).sum()
            b1 = (w * target).sum()
            det = a00 * a11 - a01 * a01
            if abs(det) < 1e-12:
                return 1.0, 0.0
            return ((a11 * b0 - a01 * b1) / det,
                    (-a01 * b0 + a00 * b1) / det)

        l1_list, l1_4m, cover = [], [], []
        for i in range(n):
            mask = masks_all[i]
            cover.append(mask.mean())
            depth = 1.0 / np.clip(disps_all[i], 1e-8, None)
            depth[~mask] = 0
            depth_gt = np.asarray(stream[int(stamps[i])][2])
            m = (depth_gt > 0) & mask
            for out, extra in ((l1_list, None), (l1_4m, depth_gt < 4)):
                mm = m if extra is None else (m & extra)
                if mm.sum() == 0:
                    out.append(np.nan)
                    continue
                d = depth.copy()
                d[~mm] = 0
                if global_scale is None:
                    sc, sh = _align_np(d, depth_gt, mm.astype(np.float32))
                    d = sc * d + sh
                else:
                    d = global_scale * d
                out.append(np.abs(d[mm] - depth_gt[mm]).mean())
        return (float(np.nanmean(l1_list)), float(np.nanmean(l1_4m)),
                float(np.mean(cover)))
