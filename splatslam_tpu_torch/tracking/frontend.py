"""Frontend: sliding-window local BA with keyframe culling + loop closure
(counterpart of splatslam_tpu/tracking/frontend.py; reference
thirdparty/glorie_slam/frontend.py:19-145).
"""

from __future__ import annotations

import torch

from .factor_graph import FactorGraph
from .backend import Backend
from ..utils.profiling import PhaseTimers


@torch.no_grad()
def _seed_next(video, t1, mean_win):
    """Seed frame t1 from t1-1: copy the pose, set the disparity to the
    mean of the last `mean_win` frames (frontend.py:95-96 / :129-130)."""
    s = video.state
    s.poses[t1] = s.poses[t1 - 1]
    s.disps[t1] = s.disps[t1 - mean_win:t1].mean()


class Frontend:
    def __init__(self, video, cfg):
        self.video = video
        self.t1 = 0
        self.is_initialized = False
        tr = cfg["tracking"]
        self.max_age = tr["max_age"]
        self.iters1 = 4 * 2
        self.iters2 = 2 * 2
        self.warmup = tr["warmup"]
        self.beta = tr["beta"]
        fe = tr["frontend"]
        self.frontend_nms = fe["nms"]
        self.keyframe_thresh = fe["keyframe_thresh"]
        self.frontend_window = fe["window"]
        self.frontend_thresh = fe["thresh"]
        self.frontend_radius = fe["radius"]
        self.frontend_max_factors = fe["max_factors"]
        self.enable_loop = fe["enable_loop"]
        self.loop_closing = Backend(video, cfg)
        self.graph = FactorGraph(video, max_factors=self.frontend_max_factors,
                                 oracle=tr.get("oracle", False))
        self.last_loop_t = -1
        self.timers = PhaseTimers()   # replaced by SLAM's shared timers

    def _rounds(self, n):
        return tuple("pose_depth" if itr % 2 == 0 else "depth_scale"
                     for itr in range(n))

    def _update(self):
        """Per-keyframe update (frontend.py:54-100)."""
        T = self.timers
        self.t1 += 1
        if len(self.graph.ii) > 0:
            self.graph.rm_factors(self.graph.age > self.max_age, store=True)

        with T("fe.edges"):
            self.graph.add_proximity_factors(
                self.t1 - 5, max(self.t1 - self.frontend_window, 0),
                rad=self.frontend_radius, nms=self.frontend_nms,
                thresh=self.frontend_thresh, beta=self.beta, remove=True)

        with T("fe.rounds"):
            d = self.graph.update_rounds(
                self._rounds(self.iters1), None, None, use_inactive=True,
                cull_pair=(self.t1 - 2, self.t1 - 1), cull_beta=self.beta)

        if d < self.keyframe_thresh:
            with T("fe.rm_kf"):
                self.graph.rm_keyframe(self.t1 - 1)
                self.video.counter -= 1
                self.t1 -= 1
        else:
            cur_t = self.video.counter
            if self.enable_loop and cur_t > self.frontend_window:
                with T("fe.loop_ba"):
                    _, n_edge = self.loop_closing.loop_ba(
                        t_start=0, t_end=cur_t, steps=self.iters2,
                        local_graph=self.graph, enable_wq=True)
                if n_edge == 0:
                    with T("fe.rounds"):
                        self.graph.update_rounds(self._rounds(self.iters2),
                                                 None, None,
                                                 use_inactive=True)
                self.last_loop_t = cur_t
            else:
                with T("fe.rounds"):
                    self.graph.update_rounds(self._rounds(self.iters2),
                                             None, None, use_inactive=True)

        _seed_next(self.video, self.t1, 1)
        if len(self.graph.ii) > 0:
            self.video.set_dirty(int(self.graph.ii.min()), self.t1)

    def _initialize(self):
        """Bootstrap after `warmup` keyframes (frontend.py:102-131)."""
        self.t1 = self.video.counter
        self.graph.add_neighborhood_factors(0, self.t1, r=3)
        self.graph.update_rounds(("pose_depth",) * 8, 1, use_inactive=True)
        self.graph.add_proximity_factors(0, 0, rad=2, nms=2,
                                         thresh=self.frontend_thresh,
                                         remove=False)
        self.graph.update_rounds(("pose_depth",) * 8, 1, use_inactive=True)
        _seed_next(self.video, self.t1, 4)
        self.is_initialized = True
        self.video.set_dirty(0, self.t1)
        self.graph.rm_factors(self.graph.ii < self.warmup - 4, store=True)

    def __call__(self):
        if not self.is_initialized and self.video.counter == self.warmup:
            self._initialize()
            self.video.update_valid_depth_mask()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()
            self.video.update_valid_depth_mask()
