"""Motion filter: keyframe admission by mean flow magnitude (counterpart of
splatslam_tpu/tracking/motion_filter.py, oracle path).

Oracle mode admits a frame when the mean ground-truth-induced flow
against the last keyframe exceeds the threshold. The JAX package still
runs the DroidNet feature/context encoders here and stores their maps in
the video; the oracle bundle adjustment never reads them, so this path
computes none. The learned admission (encoders + one GRU step over a
correlation pyramid) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..ops import lie
from .depth_video import CUDA_MIN_DEPTH


def _disp8_np(depth, down, h, w):
    """Host-side 1/8 subsample of a full-res depth map → disparity."""
    off = down // 2 - 1
    d = np.asarray(depth)[off::down, off::down][:h, :w]
    return np.where(d > 1e-6, 1.0 / np.maximum(d, 1e-6), 0.0).astype(
        np.float32)


def _img255(image):
    """Storage form for VideoState.images (uint8 0-255)."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (image * 255.0).astype(np.uint8)


class MotionFilter:
    def __init__(self, video, cfg, mono_fn=None):
        if not cfg["tracking"].get("oracle", False):
            raise NotImplementedError("learned tracker: not ported yet")
        self.video = video
        self.thresh = cfg["tracking"]["motion_filter"]["thresh"]
        self.mono_fn = mono_fn      # (tstamp, image) -> full-res depth or None
        self.count = 0
        self._last_gt = None        # (pose7, disp) of the last keyframe

    def _oracle_flow(self, gt_pose, gt_disp8, intr8):
        """Mean GT-induced flow vs the last keyframe, host numpy (mirrors
        frame_distance with β = 1)."""
        last_pose, last_disp = self._last_gt
        d_i = np.asarray(last_disp)
        h, w = d_i.shape
        fx, fy, cx, cy = [float(x) for x in np.asarray(intr8)]

        def mat(p):
            t, (x, y, z, qw) = p[:3], p[3:7]
            T = np.eye(4)
            T[:3, :3] = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - qw * z),
                 2 * (x * z + qw * y)],
                [2 * (x * y + qw * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - qw * x)],
                [2 * (x * z - qw * y), 2 * (y * z + qw * x),
                 1 - 2 * (x * x + y * y)]])
            T[:3, 3] = t
            return T

        Gij = mat(np.asarray(gt_pose)) @ np.linalg.inv(
            mat(np.asarray(last_pose)))
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        X = (xs - cx) / fx
        Y = (ys - cy) / fy
        Pj = (np.stack([X, Y, np.ones_like(X)], -1) @ Gij[:3, :3].T
              + d_i[..., None] * Gij[:3, 3])
        u = fx * Pj[..., 0] / Pj[..., 2] + cx
        v = fy * Pj[..., 1] / Pj[..., 2] + cy
        dist = np.sqrt((u - xs) ** 2 + (v - ys) ** 2)
        valid = Pj[..., 2] > CUDA_MIN_DEPTH
        d = 1000.0 if valid.mean() < 0.75 else \
            float((dist * valid).sum() / max(valid.sum(), 1e-8))
        return d, gt_disp8

    def _mono(self, tstamp, image, h8, w8):
        mono = self.mono_fn(tstamp, image) if self.mono_fn else None
        return None if mono is None else _disp8_np(mono, self.video.down,
                                                   h8, w8)

    def track(self, tstamp, image, intrinsics, gt_pose=None, gt_depth=None):
        """image (H,W,3) uint8 or float [0,1]; intrinsics (4,) full-res;
        gt_pose (7,) w2c and gt_depth (H,W) feed the oracle slots.
        Returns True when the frame was admitted as a keyframe."""
        down = self.video.down
        intr8 = np.asarray(intrinsics, np.float32) / float(down)
        h8, w8 = self.video.H // down, self.video.W // down
        gt_disp8 = (_disp8_np(gt_depth, down, h8, w8)
                    if gt_depth is not None else None)

        if self.video.counter == 0:
            self.video.append(
                tstamp, _img255(image), lie.identity().numpy(), 1.0,
                self._mono(tstamp, image, h8, w8), intr8, gt_pose=gt_pose,
                gt_depth=gt_disp8)
            if gt_pose is not None:
                d0 = gt_disp8 if gt_disp8 is not None else \
                    np.ones((h8, w8), np.float32)
                self._last_gt = (np.asarray(gt_pose), d0)
            return True

        if gt_pose is not None and self._last_gt is not None:
            delta, disp = self._oracle_flow(gt_pose, gt_disp8, intr8)
        else:
            # no GT signal for this frame: admit rather than lose track
            delta, disp = float("inf"), None
        if delta > self.thresh:
            self.count = 0
            self.video.append(
                tstamp, _img255(image), None, None,
                self._mono(tstamp, image, h8, w8), intr8, gt_pose=gt_pose,
                gt_depth=gt_disp8)
            if gt_pose is not None:
                d1 = disp if disp is not None else \
                    np.ones((h8, w8), np.float32)
                self._last_gt = (np.asarray(gt_pose), d1)
            return True
        self.count += 1
        return False
