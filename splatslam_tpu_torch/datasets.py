"""Dataset loaders (counterpart of splatslam_tpu/datasets.py).

Replica / ScanNet / TUM-RGBD readers plus the procedural Synthetic scene,
with the same resize -> edge-crop -> intrinsics-rescale pipeline and the
same per-dataset file layouts as the JAX package, so a dataset tree loads
unmodified and its frames are bit-identical between the two packages.
The recorded-sequence readers are host code (numpy + ``cv2``); Synthetic
needs neither.

Frames are returned channel-last float32 RGB in [0, 1] as host numpy:
    (index, color (H,W,3), depth (H,W) or None, c2w pose (4,4) or None)
"""

from __future__ import annotations

import glob
import os
from collections import OrderedDict

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - Synthetic runs without it
    cv2 = None


def _require_cv2(what):
    if cv2 is None:
        raise ImportError(
            f"{what} reads images with cv2 (opencv-python), which is not "
            "installed; only the 'synthetic' dataset runs without it")


def get_dataset(cfg):
    name = cfg["dataset"]
    if name not in dataset_dict:
        raise KeyError(f"unknown dataset {name!r}; expected one of "
                       f"{sorted(dataset_dict)}")
    return dataset_dict[name](cfg)


def as_intrinsics_matrix(intr):
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intr
    return K


class BaseDataset:
    def __init__(self, cfg):
        self.name = cfg["dataset"]
        self.png_depth_scale = cfg["cam"].get("png_depth_scale", 1.0)
        self.n_img = -1
        self.depth_paths = None
        self.color_paths = None
        self.poses = None

        c = cfg["cam"]
        self.H, self.W = c["H"], c["W"]
        self.fx, self.fy = c["fx"], c["fy"]
        self.cx, self.cy = c["cx"], c["cy"]
        self.fx_orig, self.fy_orig = self.fx, self.fy
        self.cx_orig, self.cy_orig = self.cx, self.cy
        self.H_out, self.W_out = c["H_out"], c["W_out"]
        self.H_edge, self.W_edge = c.get("H_edge", 0), c.get("W_edge", 0)
        self.H_out_with_edge = self.H_out + self.H_edge * 2
        self.W_out_with_edge = self.W_out + self.W_edge * 2

        intr = np.asarray([self.fx, self.fy, self.cx, self.cy], np.float32)
        intr[0] *= self.W_out_with_edge / self.W
        intr[1] *= self.H_out_with_edge / self.H
        intr[2] *= self.W_out_with_edge / self.W
        intr[3] *= self.H_out_with_edge / self.H
        intr[2] -= self.W_edge
        intr[3] -= self.H_edge
        self.fx, self.fy, self.cx, self.cy = [float(v) for v in intr]

        self.fovx = 2 * np.arctan2(self.W_out, 2 * self.fx)
        self.fovy = 2 * np.arctan2(self.H_out, 2 * self.fy)

        self.distortion = (np.asarray(c["distortion"])
                           if "distortion" in c else None)
        if "data" in cfg and "dataset_root" in cfg.get("data", {}):
            self.input_folder = os.path.join(
                cfg["data"]["dataset_root"], cfg["data"].get("input_folder", ""))
        else:
            self.input_folder = None

    def __len__(self):
        return self.n_img

    def get_intrinsic(self):
        return np.asarray([self.fx, self.fy, self.cx, self.cy], np.float32)

    def depthloader(self, index):
        if self.depth_paths is None:
            return None
        _require_cv2(type(self).__name__)
        path = self.depth_paths[index]
        depth = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if depth is None:
            raise FileNotFoundError(
                f"depth image unreadable: {path!r} (frame {index})")
        return depth.astype(np.float32) / self.png_depth_scale

    def __getitem__(self, index):
        _require_cv2(type(self).__name__)
        color = cv2.imread(self.color_paths[index])
        if color is None:
            raise FileNotFoundError(
                f"colour image unreadable: {self.color_paths[index]!r} "
                f"(frame {index})")
        if self.distortion is not None:
            K = as_intrinsics_matrix(
                [self.fx_orig, self.fy_orig, self.cx_orig, self.cy_orig])
            color = cv2.undistort(color, K, self.distortion)
        color = cv2.resize(color, (self.W_out_with_edge, self.H_out_with_edge))
        color = color[..., ::-1].astype(np.float32) / 255.0  # BGR→RGB

        depth = self.depthloader(index)
        if depth is not None:
            depth = cv2.resize(depth, (self.W_out_with_edge,
                                       self.H_out_with_edge),
                               interpolation=cv2.INTER_NEAREST)
        we, he = self.W_edge, self.H_edge
        if we > 0:
            color = color[:, we:-we]
            depth = depth[:, we:-we] if depth is not None else None
        if he > 0:
            color = color[he:-he]
            depth = depth[he:-he] if depth is not None else None
        pose = (self.poses[index].astype(np.float32)
                if self.poses is not None else None)
        return index, np.ascontiguousarray(color), depth, pose

    def get_gt_pose(self, index):
        """GT c2w WITHOUT decoding the frame's images — trajectory eval
        iterates every frame and only needs the pose (a full __getitem__
        per frame costs two image decodes + undistort + resize)."""
        if self.poses is None:
            return None
        return self.poses[index].astype(np.float32)


class Replica(BaseDataset):
    def __init__(self, cfg):
        super().__init__(cfg)
        stride = cfg.get("stride", 1)
        max_frames = cfg.get("max_frames", -1)
        if max_frames < 0:
            max_frames = int(1e5)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self.load_poses(f"{self.input_folder}/traj.txt")
        self.color_paths = self.color_paths[:max_frames][::stride]
        self.depth_paths = self.depth_paths[:max_frames][::stride]
        self.poses = self.poses[:max_frames][::stride]
        self.n_img = len(self.color_paths)

    def load_poses(self, path):
        with open(path) as f:
            lines = f.readlines()
        self.poses = [np.asarray(list(map(float, lines[i].split())),
                                 np.float64).reshape(4, 4)
                      for i in range(self.n_img)]


class ScanNet(BaseDataset):
    def __init__(self, cfg):
        super().__init__(cfg)
        stride = cfg.get("stride", 1)
        max_frames = cfg.get("max_frames", -1)
        if max_frames < 0:
            max_frames = int(1e5)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "color", "*.jpg")),
            key=lambda x: int(os.path.basename(x)[:-4]))[:max_frames][::stride]
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth", "*.png")),
            key=lambda x: int(os.path.basename(x)[:-4]))[:max_frames][::stride]
        self.load_poses(os.path.join(self.input_folder, "pose"))
        self.poses = self.poses[:max_frames][::stride]
        self.n_img = len(self.color_paths)

    def load_poses(self, path):
        self.poses = []
        for p in sorted(glob.glob(os.path.join(path, "*.txt")),
                        key=lambda x: int(os.path.basename(x)[:-4])):
            with open(p) as f:
                mat = np.asarray([list(map(float, l.split()))
                                  for l in f.readlines()]).reshape(4, 4)
            self.poses.append(mat)


class TUM_RGBD(BaseDataset):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.color_paths, self.depth_paths, self.poses = self.loadtum(
            self.input_folder, frame_rate=32)
        stride = cfg.get("stride", 1)
        max_frames = cfg.get("max_frames", -1)
        if max_frames < 0:
            max_frames = int(1e5)
        self.color_paths = self.color_paths[:max_frames][::stride]
        self.depth_paths = self.depth_paths[:max_frames][::stride]
        self.poses = self.poses[:max_frames][::stride]
        self.n_img = len(self.color_paths)

    @staticmethod
    def parse_list(filepath, skiprows=0):
        # str, not np.unicode_ (removed in numpy 2.0); atleast_2d so a
        # single-row file keeps the (rows, cols) shape
        return np.atleast_2d(np.loadtxt(filepath, delimiter=" ", dtype=str,
                                        skiprows=skiprows))

    @staticmethod
    def associate_frames(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if (np.abs(t_depth[j] - t) < max_dt
                    and np.abs(t_pose[k] - t) < max_dt):
                assoc.append((i, j, k))
        return assoc

    def loadtum(self, datapath, frame_rate=-1):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        else:
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self.parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self.parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self.parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self.associate_frames(t_img, t_depth, t_pose)

        indicies = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indicies[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indicies.append(i)

        images, poses, depths = [], [], []
        inv_pose = None
        for ix in indicies:
            (i, j, k) = assoc[ix]
            images.append(os.path.join(datapath, image_data[i, 1]))
            depths.append(os.path.join(datapath, depth_data[j, 1]))
            c2w = self.pose_matrix_from_quaternion(pose_vecs[k])
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(c2w)
        return images, depths, poses

    @staticmethod
    def pose_matrix_from_quaternion(pvec):
        from scipy.spatial.transform import Rotation
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose


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
    "replica": Replica,
    "scannet": ScanNet,
    "tumrgbd": TUM_RGBD,
    "synthetic": Synthetic,
}
