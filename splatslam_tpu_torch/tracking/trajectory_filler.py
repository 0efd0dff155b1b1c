"""Post-hoc pose recovery for non-keyframes (counterpart of
splatslam_tpu/tracking/trajectory_filler.py; reference
thirdparty/glorie_slam/trajectory_filler.py:23-123): linear SE3
interpolation between the bracketing keyframes, then 12 motion-only update
rounds per 16-frame batch against both of them.

The refinement always runs the learned update operator — also in a run
whose tracking was oracle — so it needs the keyframes' feature maps and
context in the video.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from .factor_graph import FactorGraph
from .motion_filter import encode_features_batch

BATCH = 16


class PoseTrajectoryFiller:
    def __init__(self, model, video):
        self.model = model
        self.video = video

    @torch.no_grad()
    def _fill(self, timestamps, images, intrinsics):
        """One batch of at most 16 frames (trajectory_filler.py:48-95): the
        frames become pseudo-keyframes N..N+M (pose, unit disparity,
        intrinsics and feature map only — the update operator reads nothing
        else of an edge's target frame), edges run from both bracketing
        keyframes to each, and the video's counter is put back afterwards.
        Returns their (M,7) poses."""
        v = self.video
        s = v.state
        N, M = v.counter, len(timestamps)
        if N + M > v.buffer:
            raise ValueError(
                f"trajectory filler: {N} keyframes + a batch of {M} exceed "
                f"tracking.buffer {v.buffer}")
        ts = s.timestamp[:N].cpu().numpy()
        tt = np.asarray(timestamps, np.float32)
        t0 = np.asarray([max((ts <= t).sum() - 1, 0) for t in tt])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        inv_dt = v._t(1.0 / (ts[t1] - ts[t0] + 1e-3))
        frac = v._t(tt - ts[t0])

        i0, i1 = v._idx(t0), v._idx(t1)
        vel = lie.log(lie.mul(s.poses[i1], lie.inv(s.poses[i0]))) \
            * inv_dt[:, None]
        idx = torch.arange(N, N + M, device=v.device)
        s.timestamp[idx] = v._t(tt)
        s.poses[idx] = lie.mul(lie.exp(vel * frac[:, None]), s.poses[i0])
        s.disps[idx] = 1.0
        s.intrinsics[idx] = v._t(intrinsics[0]) / v.down
        s.fmaps[idx] = encode_features_batch(
            self.model, np.stack(images)).to(s.fmaps.dtype)

        v.counter = N + M
        try:
            graph = FactorGraph(v, self.model, upsample=False)
            graph.add_factors(t0, np.arange(N, N + M))
            graph.add_factors(t1, np.arange(N, N + M))
            graph.update_rounds_motion_only(12, N, N + M)
        finally:
            v.counter = N
        return s.poses[idx].cpu().numpy()

    def __call__(self, image_stream):
        """Poses for every frame of the stream (trajectory_filler.py:97-123):
        (n_frames, 7) w2c pose vectors."""
        pose_list, stamps, images, intrs = [], [], [], []
        intrinsic = np.asarray(image_stream.get_intrinsic())
        for i in range(len(image_stream)):
            timestamp, image, _, _ = image_stream[i]
            stamps.append(timestamp)
            images.append(np.asarray(image))
            intrs.append(intrinsic)
            if len(stamps) == BATCH:
                pose_list.append(self._fill(stamps, images, intrs))
                stamps, images, intrs = [], [], []
        if stamps:
            pose_list.append(self._fill(stamps, images, intrs))
        return np.concatenate(pose_list, axis=0)
