"""Factor graph: edge bookkeeping on the host, the update operator and the
update rounds on the device (counterpart of
splatslam_tpu/tracking/factor_graph.py).

Edge sets (ii, jj, age) live in host numpy — they drive control flow
(NMS, dedup, proximity proposals), as in the reference
(factor_graph.py:337-397). Per-edge tensors — the GRU hidden state `net`
(E,128,h,w), the flow targets and weights (E,h,w,2) — live on the video's
device with exactly as many rows as edges: the JAX package pads them into
pools only to keep XLA's shapes fixed.

The update operator — reproject → local correlation → ConvGRU → delta and
weight heads → GraphAgg — is `update_operator`; on the card its local
correlation is one kernel launch that holds no volume, elsewhere it never
holds the O(N·(hw)²) correlation volume of more edges than `corr_chunk`
allows. With `oracle=True` the flow targets are instead the ground-truth
reprojection of each edge with unit weights on pixels with GT depth. Either
way the targets feed the same DSPO bundle adjustment.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba as ba_ops
from ..ops import corr as corr_ops
from ..ops import corr_cuda
from ..ops import projective as pops
from .depth_video import (reproject, depth_filter, frame_distance, nanmedian)
from ..ops.upsample import upsample_disp, upsample_disp_uniform
from ..utils.profiling import span, tally

# bytes of level-0 correlation volume (N·(h·w)²·4) one alt_corr call may hold
CORR_CHUNK_BYTES = 256 << 20


def corr_chunk(h: int, w: int) -> int:
    """Edges per alt_corr call, sized by the level-0 volume's bytes."""
    return max(1, CORR_CHUNK_BYTES // (4 * (h * w) ** 2))


def edge_frames(fmaps, ii, jj, num_levels: int = 4):
    """The feature pyramid of just the frames the edges touch, and the
    edges' rows in it: (pyramid, ii_rows, jj_rows). Constant while the edge
    set and the features are."""
    frames = torch.unique(torch.cat([ii, jj]))
    pyr = corr_ops.build_fmap_pyramid(fmaps[frames], num_levels)
    if fmaps.is_cuda:       # the layout csrc/corr.cu reads, once an edge set
        pyr = [x.contiguous(memory_format=torch.channels_last) for x in pyr]
    return pyr, torch.searchsorted(frames, ii), torch.searchsorted(frames, jj)


def update_operator(model, poses, disps, intrinsics, fmaps, inps, net,
                    target, ii, jj, pyramid=None):
    """One DROID update over an edge set (reference factor_graph.py:226-250).

    poses (B,7); disps (B,h,w); intrinsics (4,); fmaps (B,128,h,w) bf16;
    inps (B,128,h,w); net (N,128,h,w); target (N,h,w,2); ii/jj (N,) long.
    pyramid: edge_frames(fmaps, ii, jj), when the caller holds it.
    The local correlation of CUDA tensors is one launch of csrc/corr.cu
    (ops/corr_cuda), written in the network's dtype, which has no gradient;
    that of CPU tensors is ops/corr.alt_corr in chunks of corr_chunk edges.
    `n.corr.call` counts the calls, `n.corr.kernel` the launches.
    Returns (net', target', weight (N,h,w,2), eta (M,h,w), upmask
    (M,576,h,w), uniq (M,) = unique(ii), coords1), all but net' and upmask
    float32."""
    h, w = disps.shape[-2:]
    coords1, _ = reproject(poses, disps, intrinsics, ii, jj)
    coords0 = pops.coords_grid(h, w, device=disps.device)
    motn = torch.cat([coords1 - coords0, target - coords1], -1)
    motn = motn.clamp(-64.0, 64.0).permute(0, 3, 1, 2)

    pyr, ii_r, jj_r = pyramid if pyramid is not None else edge_frames(
        fmaps, ii, jj)
    tally("n.corr.call", 1)
    if corr_cuda.takes(coords1):
        corr = corr_cuda.alt_corr(pyr, ii_r, jj_r, coords1, model.dtype)
        tally("n.corr.kernel", 1)
    else:
        step = corr_chunk(h, w)
        corr = torch.cat([
            corr_ops.alt_corr(pyr, ii_r[c:c + step], jj_r[c:c + step],
                              coords1[c:c + step])
            for c in range(0, ii.shape[0], step)])
    net, delta, weight = model.update_step(net, inps[ii], corr, motn)

    uniq, ix = torch.unique(ii, return_inverse=True)
    eta, upmask = model.update_agg(net, ix, uniq.shape[0])
    target = coords1 + delta.float().permute(0, 2, 3, 1)
    weight = weight.float().permute(0, 2, 3, 1).contiguous()
    return net, target, weight, eta.float(), upmask, uniq, coords1


class FactorGraph:
    """Mirrors the reference FactorGraph API. `model` is the DroidNet the
    learned update runs (unused when oracle); tensors live on the video's
    device."""

    def __init__(self, video, model, max_factors=-1, upsample=True,
                 oracle=False):
        self.video = video
        self.model = model
        self.device = video.device
        self.max_factors = max_factors
        self.upsample_flag = upsample
        self.oracle = oracle
        self.h = video.H // video.down
        self.w = video.W // video.down
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)
        z = lambda: torch.zeros((0, self.h, self.w, 2), device=self.device)
        self.target, self.weight = z(), z()
        self.target_inac, self.weight_inac = z(), z()
        # per-edge GRU state; the oracle update has none
        self.net = None if oracle else torch.zeros(
            (0, 128, self.h, self.w), device=self.device)
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.ii_bad = np.zeros(0, np.int64)
        self.jj_bad = np.zeros(0, np.int64)
        # per-keyframe damping; only the learned update rewrites it
        self.damping_maps = 1e-6 * torch.ones(
            (video.buffer, self.h, self.w), device=self.device)

    def _idx(self, ix):
        return torch.as_tensor(np.asarray(ix, np.int64).reshape(-1),
                               device=self.device)

    # -- edge mutation (factor_graph.py:111-223) ----------------------------

    def _filter_repeated_edges(self, ii, jj):
        eset = set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep = np.asarray([(i, j) not in eset for i, j in zip(ii, jj)], bool)
        return ii[keep], jj[keep]

    @torch.no_grad()
    def add_factors(self, ii, jj, remove=False):
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        ii, jj = self._filter_repeated_edges(ii, jj)
        if ii.shape[0] == 0:
            return
        if (self.max_factors > 0
                and self.ii.shape[0] + ii.shape[0] > self.max_factors
                and self.ii.shape[0] > 0 and remove):
            ix = np.argsort(self.age)
            keep_rank = np.empty_like(ix)
            keep_rank[ix] = np.arange(len(ix))
            self.rm_factors(keep_rank >= (self.max_factors - ii.shape[0]),
                            store=True)
        tgt, _ = self.video.reproject(ii, jj)
        self.target = torch.cat([self.target, tgt])
        self.weight = torch.cat([self.weight, torch.zeros_like(tgt)])
        if self.net is not None:
            self.net = torch.cat([self.net, self.video.get_nets(ii)])
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros_like(ii)])

    def rm_factors(self, mask, store=False):
        mask = np.asarray(mask, bool)
        if mask.sum() == 0:
            return
        m = self._idx(np.where(mask)[0])
        keep = self._idx(np.where(~mask)[0])
        if store:
            self.target_inac = torch.cat([self.target_inac, self.target[m]])
            self.weight_inac = torch.cat([self.weight_inac, self.weight[m]])
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
        self.target = self.target[keep]
        self.weight = self.weight[keep]
        if self.net is not None:
            self.net = self.net[keep]
        self.ii = self.ii[~mask]
        self.jj = self.jj[~mask]
        self.age = self.age[~mask]

    def filter_edges(self):
        """Remove edges with low confidence (factor_graph.py:83-90)."""
        conf = self.weight.mean(dim=(1, 2, 3)).cpu().numpy()
        mask = (np.abs(self.ii - self.jj) > 2) & (conf < 0.001)
        self.ii_bad = np.concatenate([self.ii_bad, self.ii[mask]])
        self.jj_bad = np.concatenate([self.jj_bad, self.jj[mask]])
        self.rm_factors(mask, store=False)

    def clear_edges(self):
        self.__init__(self.video, self.model, self.max_factors,
                      self.upsample_flag, self.oracle)

    @torch.no_grad()
    def rm_keyframe(self, ix):
        """Drop keyframe ix: shift the video buffer down and fix up edge
        indices (factor_graph.py:187-223)."""
        v = self.video
        src = np.arange(v.buffer)
        src[ix:-1] = src[ix:-1] + 1
        src = self._idx(src)
        s = v.state
        for f in s.__dataclass_fields__:
            setattr(s, f, getattr(s, f)[src])
        self.damping_maps = self.damping_maps[src]
        v.dirty[ix:-1] = v.dirty[ix + 1:]
        v.npc_dirty[ix:-1] = v.npc_dirty[ix + 1:]

        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1,
                                self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1,
                                self.jj_inac)
        if m.any():
            keep = self._idx(np.where(~m)[0])
            self.target_inac = self.target_inac[keep]
            self.weight_inac = self.weight_inac[keep]
            self.ii_inac = self.ii_inac[~m]
            self.jj_inac = self.jj_inac[~m]

        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)

    # -- the update operator (factor_graph.py:226-270) -----------------------

    def _oracle_targets(self):
        """GT-flow targets of the active edges, unit weight on pixels with
        GT depth (hole pixels have gt_disp == 0)."""
        s = self.video.state
        ii, jj = self._idx(self.ii), self._idx(self.jj)
        coords, valid = reproject(s.gt_poses, s.gt_disps, self.video.intr0,
                                  ii, jj)
        has_depth = (s.gt_disps[ii] > 1e-8)[..., None]
        return coords, (valid * has_depth).expand_as(coords).contiguous()

    def _learned_update(self, poses, disps, pyramid=None):
        """update_operator on the active edges at the given poses and
        disparities; writes net/target/weight and the touched keyframes'
        damping. Returns (uniq, upmask)."""
        s = self.video.state
        ii, jj = self._idx(self.ii), self._idx(self.jj)
        self.net, self.target, self.weight, eta, upmask, uniq, _ = \
            update_operator(self.model, poses, disps, self.video.intr0,
                            s.fmaps, s.inps, self.net, self.target, ii, jj,
                            pyramid)
        self.damping_maps[uniq] = eta
        return uniq, upmask

    def _pyramid(self):
        return edge_frames(self.video.state.fmaps, self._idx(self.ii),
                           self._idx(self.jj))

    def _inactive(self, t0, use_inactive):
        if not use_inactive:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    self.target_inac[:0], self.weight_inac[:0])
        m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
        sel = self._idx(np.where(m)[0])
        return (self.ii_inac[m], self.jj_inac[m], self.target_inac[sel],
                self.weight_inac[sel])

    @torch.no_grad()
    def update(self, t0=None, t1=None, itrs=2, use_inactive=False, EP=1e-7,
               motion_only=False, opt_type="pose_depth"):
        """One update (learned operator, or oracle targets) + BA through
        the DSPO dispatch (DepthVideo.ba), then upsampling of the touched
        frames (convex with the network's mask, uniform when oracle)."""
        if self.ii.shape[0] == 0:
            return
        s = self.video.state
        upmask = None
        if self.oracle:
            self.target, self.weight = self._oracle_targets()
        else:
            _, upmask = self._learned_update(s.poses, s.disps)
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        ii_in, jj_in, t_in, w_in = self._inactive(t0, use_inactive)
        ii = np.concatenate([ii_in, self.ii])
        jj = np.concatenate([jj_in, self.jj])
        uniq_all = np.unique(ii)
        if self.oracle:
            damping = torch.full((len(uniq_all), self.h, self.w), 1e-4,
                                 device=self.device)
        else:
            damping = 0.2 * self.damping_maps[self._idx(uniq_all)] + EP
        self.video.ba(torch.cat([t_in, self.target]),
                      torch.cat([w_in, self.weight]), damping, ii, jj, t0,
                      t1, iters=itrs, lm=1e-4, ep=0.1,
                      motion_only=motion_only, opt_type=opt_type)
        if self.upsample_flag:
            self.video.upsample(np.unique(self.ii), upmask)
        self.age += 1

    @torch.no_grad()
    def update_rounds(self, opt_types, t0=None, t1=None, use_inactive=False,
                      EP=1e-7, upsample=True, cull_pair=None,
                      cull_beta=0.3):
        """len(opt_types) update rounds (_fused_rounds of the JAX package):
        each runs the update operator on the active edges (oracle: the GT
        targets, constant over the rounds), then a DSPO stage-1
        (pose_depth: 2 DBA iterations) or stage-2 (depth_scale: multiview
        mask + scale/shift refit, then 2 stage-2 iterations) step over the
        active edges plus the inactive edges near the window. Then the
        touched disparities are upsampled once, with the last round's mask.
        cull_pair=(i, j): returns the bidirectional keyframe-cull distance
        d(i, j) on the post-round state."""
        if len(self.ii) == 0:
            return None
        v = self.video
        s = v.state
        if v.BA_type != "DSPO":
            opt_types = tuple("pose_depth" for _ in opt_types)
        with span("fe.setup"):
            if t0 is None:
                t0 = max(1, int(self.ii.min()) + 1)
            ii_in, jj_in, t_in, w_in = self._inactive(t0, use_inactive)
            if t1 is None:
                t1 = int(max(self.ii.max(), self.jj.max(),
                             ii_in.max() if len(ii_in) else 0,
                             jj_in.max() if len(jj_in) else 0)) + 1
            n_edges = len(self.ii) + len(ii_in)
            edges = ba_ops.make_edges(np.concatenate([self.ii, ii_in]),
                                      np.concatenate([self.jj, jj_in]),
                                      int(t0), int(t1), self.device)
            upmask = None
            if self.oracle:
                self.target, self.weight = self._oracle_targets()
            else:
                pyramid = self._pyramid()
        mv_cfg = v.cfg["tracking"]["multiview_filter"]
        intr = v.intr0

        poses, disps = s.poses, s.disps
        for opt_type in opt_types:
            with span("fe.round"):
                tally("n.edges", n_edges)
                if not self.oracle:
                    with span("fe.update"):
                        _, upmask = self._learned_update(poses, disps,
                                                         pyramid)
                target_all = torch.cat([self.target, t_in])
                weight_all = torch.cat([self.weight, w_in])
                eta = 0.2 * self.damping_maps[edges.kx] + EP
                stage1 = opt_type != "depth_scale"
                if not stage1:
                    with span("fe.dspo"):
                        stage1, disps = self._dspo_round(
                            poses, disps, edges, target_all, weight_all,
                            eta, mv_cfg)
                if stage1:
                    with span("fe.dba"):
                        poses, disps = ba_ops.dba(
                            poses, disps, intr, target_all, weight_all, eta,
                            torch.zeros_like(disps), edges, iters=2)
        s.poses, s.disps = poses, disps

        if upsample and self.upsample_flag:
            v.upsample(np.unique(self.ii), upmask)
        self.age += len(opt_types)
        # JAX factor_graph.py:887-898, per edge-pixel and round: the learned
        # operator ≈ 2.8 MF (alt-corr + ConvGRU and heads), the oracle
        # reprojection ≈ 2 kF; DBA ≈ 1.5 kF per plan edge-pixel and
        # Gauss-Newton iteration, 2 iterations a round
        px = self.h * self.w
        per_round = (2e3 if self.oracle else 2.8e6) * n_edges * px \
            + 2 * 1.5e3 * edges.ii.shape[0] * px
        v.flops_tracking += per_round * len(opt_types)
        if cull_pair is None:
            return None
        with span("fe.cull"):
            ci = self._idx([cull_pair[0]])
            cj = self._idx([cull_pair[1]])
            return float(0.5 * (
                frame_distance(poses, disps, intr, ci, cj, cull_beta)
                + frame_distance(poses, disps, intr, cj, ci, cull_beta))[0])

    def _dspo_round(self, poses, disps, edges, target_all, weight_all, eta,
                    mv_cfg):
        """A stage-2 round: refresh the multiview mask and the (w, q)
        init of the touched frames (depth_video.py:236-251 semantics), then
        two scale/shift iterations. Returns (fall_back, disps): fall_back
        when every edge is dropped as bad-mono, the round then being a
        stage-1 one."""
        v = self.video
        s = v.state
        intr = v.intr0
        kx = edges.kx
        d_kx = disps[kx]
        depths = 1.0 / torch.clamp(d_kx, min=1e-8)
        thr = mv_cfg["thresh"] * depths.mean(dim=(1, 2))
        count = depth_filter(poses, disps, intr, kx, thr)
        mv = count >= mv_cfg["visible_num"]
        med = nanmedian(torch.where(
            mv, depths, torch.full_like(depths, float("nan"))
        ).reshape(len(kx), -1))
        s.valid_depth_mask_small[kx] = mv & (
            depths < 3 * med[:, None, None])
        sc, sh, _ = ba_ops.align_scale_and_shift(
            s.mono_disps[kx], d_kx, s.valid_depth_mask_small[kx])
        s.depth_scale[kx] = sc
        s.depth_shift[kx] = sh
        w2, kx_mask = weight_all, None
        if v.mono_thres:
            # bad-mono edges dropped as a zero weight; frames left with
            # no kept edge are frozen (unless inside [t0, t1)); if
            # every edge drops the round falls back to stage 1
            bad = ba_ops.bad_mono_frames(
                s.mono_disps, disps, s.valid_depth_mask_small,
                float(v.mono_thres))
            keep_e = ~bad[edges.ii] & ~bad[edges.jj]
            # one host pull: the kept edges, and the depth frames dropped
            n_kept, n_bad = torch.stack(
                (keep_e.sum(), bad[kx].sum())).tolist()
            tally("n.dspo.bad_mono", n_bad)
            tally("n.dspo.frames", edges.M)
            if not n_kept:
                return True, disps
            kept = torch.zeros(edges.M, device=self.device).index_add_(
                0, edges.kk, keep_e.float()) > 0
            kx_mask = kept | (kx >= edges.t0)
            w2 = weight_all * keep_e[:, None, None, None]
        for _ in range(2):
            disps, s.depth_scale, s.depth_shift = \
                ba_ops._scale_shift_iteration(
                    poses, disps, intr, target_all, w2, eta,
                    s.mono_disps, s.depth_scale, s.depth_shift,
                    s.valid_depth_mask_small, edges, 1e-4, 0.1, 0.01,
                    kx_mask=kx_mask)
        return False, disps

    @torch.no_grad()
    def update_rounds_motion_only(self, rounds, t0, t1):
        """`rounds` motion-only update rounds (update operator + 2 pose-only
        Gauss-Newton steps): poses in [t0, t1) move, everything else is
        frozen. The trajectory filler's refinement
        (trajectory_filler.py:85-90)."""
        if len(self.ii) == 0:
            return
        s = self.video.state
        edges = ba_ops.make_edges(self.ii, self.jj, int(t0), int(t1),
                                  self.device)
        pyramid = self._pyramid()
        poses = s.poses
        for _ in range(rounds):
            self._learned_update(poses, s.disps, pyramid)
            poses, _ = ba_ops.dba(poses, s.disps, self.video.intr0,
                                  self.target, self.weight, None, None,
                                  edges, iters=2, motion_only=True)
        s.poses = poses
        self.age += rounds

    def update_lowmem(self, t0=None, t1=None, itrs=2, use_inactive=False,
                      EP=1e-7, steps=8, enable_wq=True, motion_only=False):
        """Global-BA update loop (factor_graph.py:273-323): `steps` rounds
        alternating stage 1 and (with enable_wq) stage 2; motion_only
        routes to the pose-only rounds."""
        if motion_only:
            if t1 is None:
                t1 = self.video.counter
            self.update_rounds_motion_only(steps, t0 or 0, t1)
            return
        opt_types = tuple(
            "pose_depth" if (step % 2 == 0 or not enable_wq)
            else "depth_scale" for step in range(steps))
        self.update_rounds(opt_types, t0=t0, t1=t1,
                           use_inactive=use_inactive, EP=EP)

    # -- edge proposal (factor_graph.py:326-476) -----------------------------

    def add_neighborhood_factors(self, t0, t1, r=3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii = ii.reshape(-1)
        jj = jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False):
        t = self.video.counter
        ix_r = np.arange(t0, t)
        jx_r = np.arange(t1, t)
        if len(ix_r) == 0 or len(jx_r) == 0:
            return
        ii, jj = np.meshgrid(ix_r, jx_r, indexing="ij")
        ii = ii.reshape(-1)
        jj = jj.reshape(-1)
        d = self.video.distance(ii, jj, beta=beta).copy()
        d[ii - rad < jj] = np.inf
        d[d > 100] = np.inf

        ii1 = np.concatenate([self.ii, self.ii_bad, self.ii_inac])
        jj1 = np.concatenate([self.jj, self.jj_bad, self.jj_inac])

        def suppress(i, j):
            for di in range(-nms, nms + 1):
                for dj in range(-nms, nms + 1):
                    if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                        i1, j1 = i + di, j + dj
                        if (t0 <= i1 < t) and (t1 <= j1 < t):
                            d[(i1 - t0) * (t - t1) + (j1 - t1)] = np.inf

        for i, j in zip(ii1, jj1):
            suppress(int(i), int(j))

        es = []
        for i in range(t0, t):
            for j in range(max(i - rad - 1, 0), i):
                es.append((i, j))
                es.append((j, i))
                d[(i - t0) * (t - t1) + (j - t1)] = np.inf

        for k in np.argsort(d):
            if d[k] > thresh:
                continue
            if len(es) > self.max_factors:
                break
            i, j = int(ii[k]), int(jj[k])
            es.append((i, j))
            es.append((j, i))
            suppress(i, j)

        if es:
            es = np.asarray(es)
            self.add_factors(es[:, 0], es[:, 1], remove)

    def add_backend_proximity_factors(self, t_start, t_end, nms, radius,
                                      thresh, max_factors, beta,
                                      t_start_loop=None, loop=False):
        """Backend/loop-closure edge proposal (factor_graph.py:400-476)."""
        if t_start_loop is None or not loop:
            t_start_loop = t_start
        ilen = t_end - t_start_loop
        jlen = t_end - t_start
        if ilen <= 0 or jlen <= 0:
            return 0
        ii, jj = np.meshgrid(np.arange(t_start_loop, t_end),
                             np.arange(t_start, t_end), indexing="ij")
        ii = ii.reshape(-1)
        jj = jj.reshape(-1)
        d = self.video.distance(ii, jj, beta=beta).copy()
        rawd = d.copy().reshape(ilen, jlen)
        d[ii - radius < jj] = np.inf
        d[d > thresh] = np.inf
        d = d.reshape(ilen, jlen)

        es = []
        for i in range(t_start_loop, t_end):
            for j in range(max(i - radius - 1, 0), i):
                es.append((i, j))
                es.append((j, i))
                d[i - t_start_loop, j - t_start] = np.inf

        loop_edges = 0
        n_neighboring = 1
        for k in np.argsort(d.reshape(-1)):
            di, dj = k // jlen, k % jlen
            if d[di, dj] > thresh:
                # continue, not break: a candidate wiped by an earlier
                # pick's NMS window appears mid-sequence
                continue
            if len(es) > max_factors:
                break
            i, j = int(ii[k]), int(jj[k])
            if loop:
                sub = []
                for si in range(max(i - n_neighboring, t_start_loop),
                                min(i + n_neighboring + 1, t_end)):
                    for sj in range(max(j - n_neighboring, t_start),
                                    min(j + n_neighboring + 1, t_end)):
                        if rawd[si - t_start_loop, sj - t_start] <= thresh \
                                and si != sj and si - sj > 20:
                            sub.append((si, sj))
                es += sub
                loop_edges += len(sub)
            else:
                es.append((i, j))
                es.append((j, i))
            d[max(0, di - nms):min(ilen, di + nms + 1),
              max(0, dj - nms):min(jlen, dj + nms + 1)] = np.inf

        if len(es) < 3 or (loop and loop_edges == 0):
            return 0
        es = np.asarray(es)
        self.add_factors(es[:, 0], es[:, 1], remove=True)
        return len(self.ii)
