"""Dataset loaders (counterpart of splatslam_tpu/datasets.py).

This slice of the port carries the procedural Synthetic dataset only —
the scene every smoke run and benchmark uses; the Replica, ScanNet and
TUM-RGBD readers are not ported yet and fail loudly.

Frames are returned channel-last float32 RGB in [0, 1] as host numpy:
    (index, color (H,W,3), depth (H,W) or None, c2w pose (4,4) or None)
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


def get_dataset(cfg):
    name = cfg["dataset"]
    if name not in dataset_dict:
        raise NotImplementedError(f"dataset {name!r}: not ported yet")
    return dataset_dict[name](cfg)


class BaseDataset:
    def __init__(self, cfg):
        self.name = cfg["dataset"]
        c = cfg["cam"]
        self.H, self.W = c["H"], c["W"]
        self.fx, self.fy = c["fx"], c["fy"]
        self.cx, self.cy = c["cx"], c["cy"]
        self.H_out, self.W_out = c["H_out"], c["W_out"]
        self.H_edge, self.W_edge = c.get("H_edge", 0), c.get("W_edge", 0)
        H_e = self.H_out + self.H_edge * 2
        W_e = self.W_out + self.W_edge * 2

        intr = np.asarray([self.fx, self.fy, self.cx, self.cy], np.float32)
        intr[0] *= W_e / self.W
        intr[1] *= H_e / self.H
        intr[2] *= W_e / self.W
        intr[3] *= H_e / self.H
        intr[2] -= self.W_edge
        intr[3] -= self.H_edge
        self.fx, self.fy, self.cx, self.cy = [float(v) for v in intr]
        self.n_img = -1
        self.poses = None

    def __len__(self):
        return self.n_img

    def get_intrinsic(self):
        return np.asarray([self.fx, self.fy, self.cx, self.cy], np.float32)

    def get_gt_pose(self, index):
        if self.poses is None:
            return None
        return self.poses[index].astype(np.float32)


class Synthetic(BaseDataset):
    """Procedural scene: a textured height-field room rendered by point
    splatting with a z-buffer. Bit-identical to the JAX package's
    Synthetic for the same config (same numpy RandomState draws)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        syn = cfg.get("synthetic", {})
        self.n_img = syn.get("n_frames", 60)
        max_frames = cfg.get("max_frames", -1)
        if max_frames > 0:
            self.n_img = min(self.n_img, max_frames)
        self.seed = syn.get("seed", 7)
        self.motion_scale = syn.get("motion_scale", 1.0)
        self.loop_period = syn.get("loop_period", 0)
        self._frame_cache = OrderedDict()
        self._build_scene()

    def _build_scene(self):
        rng = np.random.RandomState(self.seed)
        H, W = self.H_out, self.W_out
        d = rng.rand(H, W).astype(np.float32)
        for _ in range(40):
            d = 0.25 * (np.roll(d, 1, 0) + np.roll(d, -1, 0)
                        + np.roll(d, 1, 1) + np.roll(d, -1, 1))
        d = 1.5 + 2.0 * (d - d.min()) / (np.ptp(d) + 1e-8)
        tex = rng.rand(H, W, 3).astype(np.float32)
        for _ in range(2):
            tex = 0.25 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                          + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        X = (xs - self.cx) / self.fx * d
        Y = (ys - self.cy) / self.fy * d
        self.points = np.stack([X, Y, d], -1).reshape(-1, 3)
        self.colors = tex.reshape(-1, 3)
        ms = self.motion_scale
        A = 0.06 * ms
        R_amp = 0.015 * ms
        self.poses = []
        for k0 in range(self.n_img):
            if self.loop_period > 0:
                P = float(self.loop_period)
                k = P - abs(k0 % (2.0 * P) - P)
            else:
                k = float(k0)
            c2w = np.eye(4)
            ang = R_amp * np.asarray([np.sin(k / 6.0),
                                      np.sin(k / 9.0 + 1.0),
                                      0.5 * np.sin(k / 13.0 + 2.0)])
            cx_, cy_, cz_ = np.cos(ang)
            sx_, sy_, sz_ = np.sin(ang)
            Rx = np.asarray([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]])
            Ry = np.asarray([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            Rz = np.asarray([[cz_, -sz_, 0], [sz_, cz_, 0], [0, 0, 1]])
            c2w[:3, :3] = Rz @ Ry @ Rx
            c2w[:3, 3] = A * np.asarray([np.sin(k / 4.0),
                                         0.6 * np.sin(k / 6.0 + 1.0),
                                         0.8 * np.sin(k / 8.0 + 2.0)])
            self.poses.append(c2w.astype(np.float64))

    def _render(self, c2w):
        H, W = self.H_out, self.W_out
        w2c = np.linalg.inv(c2w)
        P = (w2c[:3, :3] @ self.points.T).T + w2c[:3, 3]
        z = P[:, 2]
        ok = z > 0.1
        u = np.round(self.fx * P[ok, 0] / z[ok] + self.cx).astype(np.int64)
        v = np.round(self.fy * P[ok, 1] / z[ok] + self.cy).astype(np.int64)
        inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        u, v = u[inb], v[inb]
        zi = z[ok][inb]
        ci = self.colors[ok][inb]
        order = np.argsort(-zi)
        img = np.zeros((H, W, 3), np.float32)
        dep = np.zeros((H, W), np.float32)
        flat = v[order] * W + u[order]
        img.reshape(-1, 3)[flat] = ci[order]
        dep.reshape(-1)[flat] = zi[order]
        for _ in range(16):
            hole = dep == 0
            if not hole.any():
                break
            for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                cand_d = np.roll(dep, (dy, dx), (0, 1))
                cand_i = np.roll(img, (dy, dx), (0, 1))
                fill = hole & (cand_d > 0)
                dep[fill] = cand_d[fill]
                img[fill] = cand_i[fill]
                hole = dep == 0
        return img, dep

    def __getitem__(self, index):
        # bounded LRU: each frame is read ~3x (tracking, mapper, eval)
        cached = self._frame_cache
        if index in cached:
            cached.move_to_end(index)
        else:
            c2w = self.poses[index]
            img, dep = self._render(c2w)
            cached[index] = (img, dep, c2w.astype(np.float32))
            while len(cached) > 64:
                cached.popitem(last=False)
        img, dep, c2w = cached[index]
        return index, img, dep, c2w


dataset_dict = {
    "synthetic": Synthetic,
}
