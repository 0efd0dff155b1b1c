"""Factor graph: edge bookkeeping on the host, oracle update rounds on the
device (counterpart of splatslam_tpu/tracking/factor_graph.py).

Edge sets (ii, jj, age) live in host numpy — they drive control flow
(NMS, dedup, proximity proposals), as in the reference
(factor_graph.py:337-397). Per-edge targets and weights are tensors on the
video's device, exactly as many rows as edges.

This slice carries the oracle update only: flow targets are the
ground-truth reprojection of each edge (gt poses and gt disparities) with
unit weights on pixels with GT depth, followed by the same DSPO bundle
adjustment the learned update feeds. The learned update operator (DroidNet
GRU over a correlation pyramid) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba as ba_ops
from .depth_video import (reproject, depth_filter, frame_distance, nanmedian)
from ..ops.upsample import upsample_disp_uniform


class FactorGraph:
    def __init__(self, video, max_factors=-1, upsample=True, oracle=True):
        if not oracle:
            raise NotImplementedError("learned tracker: not ported yet")
        self.video = video
        self.device = video.device
        self.max_factors = max_factors
        self.upsample_flag = upsample
        self.h = video.H // video.down
        self.w = video.W // video.down
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)
        z = lambda: torch.zeros((0, self.h, self.w, 2), device=self.device)
        self.target, self.weight = z(), z()
        self.target_inac, self.weight_inac = z(), z()
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.ii_bad = np.zeros(0, np.int64)
        self.jj_bad = np.zeros(0, np.int64)
        # per-keyframe damping; the oracle update never rewrites it
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
        self.ii = self.ii[~mask]
        self.jj = self.jj[~mask]
        self.age = self.age[~mask]

    def clear_edges(self):
        self.__init__(self.video, self.max_factors, self.upsample_flag)

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

    # -- the oracle update (factor_graph.py:703-752) ------------------------

    def _oracle_targets(self):
        """GT-flow targets of the active edges, unit weight on pixels with
        GT depth (hole pixels have gt_disp == 0)."""
        s = self.video.state
        ii, jj = self._idx(self.ii), self._idx(self.jj)
        coords, valid = reproject(s.gt_poses, s.gt_disps, self.video.intr0,
                                  ii, jj)
        has_depth = (s.gt_disps[ii] > 1e-8)[..., None]
        return coords, (valid * has_depth).expand_as(coords).contiguous()

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
        """One oracle update + BA through the DSPO dispatch
        (DepthVideo.ba), then uniform upsampling of the touched frames."""
        if self.ii.shape[0] == 0:
            return
        self.target, self.weight = self._oracle_targets()
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        ii_in, jj_in, t_in, w_in = self._inactive(t0, use_inactive)
        ii = np.concatenate([ii_in, self.ii])
        jj = np.concatenate([jj_in, self.jj])
        damping = torch.full((len(np.unique(ii)), self.h, self.w), 1e-4,
                             device=self.device)
        self.video.ba(torch.cat([t_in, self.target]),
                      torch.cat([w_in, self.weight]), damping, ii, jj, t0,
                      t1, iters=itrs, lm=1e-4, ep=0.1,
                      motion_only=motion_only, opt_type=opt_type)
        if self.upsample_flag:
            self.video.upsample(np.unique(self.ii))
        self.age += 1

    @torch.no_grad()
    def update_rounds(self, opt_types, t0=None, t1=None, use_inactive=False,
                      EP=1e-7, upsample=True, cull_pair=None,
                      cull_beta=0.3):
        """len(opt_types) oracle update rounds, each a DSPO stage-1
        (pose_depth: 2 DBA iterations) or stage-2 (depth_scale: multiview
        mask + scale/shift refit, then 2 stage-2 iterations) round over
        the active edges plus the inactive edges near the window
        (_fused_rounds with use_net=False). Then the touched disparities
        are upsampled once. cull_pair=(i, j): returns the bidirectional
        keyframe-cull distance d(i, j) on the post-round state."""
        if len(self.ii) == 0:
            return None
        v = self.video
        s = v.state
        if v.BA_type != "DSPO":
            opt_types = tuple("pose_depth" for _ in opt_types)
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        ii_in, jj_in, t_in, w_in = self._inactive(t0, use_inactive)
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max(),
                         ii_in.max() if len(ii_in) else 0,
                         jj_in.max() if len(jj_in) else 0)) + 1
        edges = ba_ops.make_edges(np.concatenate([self.ii, ii_in]),
                                  np.concatenate([self.jj, jj_in]),
                                  int(t0), int(t1), self.device)
        mv_cfg = v.cfg["tracking"]["multiview_filter"]
        intr = v.intr0
        eta = 0.2 * self.damping_maps[edges.kx] + EP

        # the oracle targets depend on GT only: constant over the rounds
        self.target, self.weight = self._oracle_targets()
        target_all = torch.cat([self.target, t_in])
        weight_all = torch.cat([self.weight, w_in])

        poses, disps = s.poses, s.disps
        for opt_type in opt_types:
            if opt_type != "depth_scale":
                poses, disps = ba_ops.dba(
                    poses, disps, intr, target_all, weight_all, eta,
                    torch.zeros_like(disps), edges, iters=2)
                continue
            # stage-2: refresh the multiview mask + (w, q) init for the
            # touched frames (depth_video.py:236-251 semantics)
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
                if not bool(keep_e.any()):
                    poses, disps = ba_ops.dba(
                        poses, disps, intr, target_all, weight_all, eta,
                        torch.zeros_like(disps), edges, iters=2)
                    continue
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
        s.poses, s.disps = poses, disps

        if upsample and self.upsample_flag:
            uniq = self._idx(np.unique(self.ii))
            s.disps_up[uniq] = upsample_disp_uniform(disps[uniq])
        self.age += len(opt_types)
        if cull_pair is None:
            return None
        ci, cj = self._idx([cull_pair[0]]), self._idx([cull_pair[1]])
        return float(0.5 * (
            frame_distance(poses, disps, intr, ci, cj, cull_beta)
            + frame_distance(poses, disps, intr, cj, ci, cull_beta))[0])

    def update_lowmem(self, t0=None, t1=None, itrs=2, use_inactive=False,
                      EP=1e-7, steps=8, enable_wq=True, motion_only=False):
        """Global-BA update loop (factor_graph.py:273-323): `steps` rounds
        alternating stage 1 and (with enable_wq) stage 2."""
        if motion_only:
            raise NotImplementedError(
                "motion-only rounds (trajectory filler): not ported yet")
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
