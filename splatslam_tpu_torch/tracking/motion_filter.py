"""Motion filter: keyframe admission by mean flow magnitude (counterpart of
splatslam_tpu/tracking/motion_filter.py; reference
thirdparty/glorie_slam/motion_filter.py:23-105).

Learned mode, per frame: encode features, correlate against the last
keyframe, run one update-operator step from the keyframe's context, and
admit the frame when the mean flow revision exceeds the threshold
(`track_kernel`). `admission_scan` decides a whole chunk of frames with one
host pull; its chain of decisions equals the per-frame one.

Oracle mode admits on the mean ground-truth-induced flow instead, and then
encodes the admitted keyframe's features and context all the same: the
trajectory filler reads the feature maps in every mode.

Images reach the network as uint8 0-255 or float [0,1], (H,W,3); feature,
net and context maps are channel-first (128,h,w).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.droid_net import normalize_images
from ..ops import corr as corr_ops
from ..ops import lie
from ..ops import projective as pops
from ..utils.profiling import PhaseTimers
from .depth_video import CUDA_MIN_DEPTH


def _disp8_np(depth, down, h, w):
    """Host-side 1/8 subsample of a full-res depth map → disparity."""
    off = down // 2 - 1
    d = np.asarray(depth)[off::down, off::down][:h, :w]
    return np.where(d > 1e-6, 1.0 / np.maximum(d, 1e-6), 0.0).astype(
        np.float32)


def _img255(image):
    """Storage form for VideoState.images (uint8 0-255)."""
    if torch.is_tensor(image):
        return image if image.dtype == torch.uint8 else \
            (image * 255.0).to(torch.uint8)
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (image * 255.0).astype(np.uint8)


def _on(model, image):
    """An image or image batch as a tensor on the model's device."""
    return torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                           else image, device=model.device)


@torch.no_grad()
def encode_features_batch(model, images):
    """images (B,H,W,3) → fmaps (B,128,h,w) in the network's dtype."""
    return model.features(normalize_images(_on(model, images)))


def encode_features(model, image):
    """image (H,W,3) → fmap (128,h,w)."""
    return encode_features_batch(model, _on(model, image)[None])[0]


@torch.no_grad()
def encode_context(model, image):
    """image (H,W,3) → (net, inp), each (128,h,w) float32."""
    cn, ci = model.context(normalize_images(_on(model, image)[None]))
    return cn[0].float(), ci[0].float()


@torch.no_grad()
def flow_magnitude(model, fmap_last, gmap, net_last, inp_last):
    """One update-operator step against the last keyframe; the mean ‖delta‖
    as a device scalar (motion_filter.py:85-94)."""
    h, w = fmap_last.shape[-2:]
    coords0 = pops.coords_grid(h, w, device=fmap_last.device)[None]
    pyr = corr_ops.build_corr_pyramid(fmap_last[None],
                                      gmap[None].to(fmap_last.dtype))
    corr = corr_ops.lookup_pyramid(pyr, coords0)
    _, delta, _ = model.update_step(net_last[None], inp_last[None], corr)
    return delta.float().norm(dim=1).mean()


def track_kernel(model, image, fmap_last, net_last, inp_last):
    """The per-frame motion check: (fmap of the frame, mean flow-revision
    magnitude against the last keyframe)."""
    gmap = encode_features(model, image)
    return gmap, flow_magnitude(model, fmap_last, gmap, net_last, inp_last)


@torch.no_grad()
def admission_scan(model, images_u8, fmap0, net0, inp0, thresh):
    """The motion check for a chunk of frames (C,H,W,3) without a host
    round trip per frame. The admission chain is sequential — each frame is
    held against the last admitted one — but depends only on the filter's
    own state, carried as (fmap, net, inp) and advanced by a `torch.where`
    on the device-side decision. The encoders, which do not depend on the
    chain, run once over the whole chunk; context is therefore computed for
    every frame, not only the admitted ones.

    Returns (pack, gmaps, nets, inps): pack = [admit flags | deltas] (2C,)
    float32, the only tensor the host needs; the per-frame maps stay on the
    device and are sliced on admission."""
    x = normalize_images(_on(model, images_u8))
    gmaps = model.features(x)
    nets, inps = model.context(x)
    nets, inps = nets.float(), inps.float()
    fmap, net_c, inp_c = fmap0, net0, inp0
    admits, dmags = [], []
    for k in range(gmaps.shape[0]):
        dmag = flow_magnitude(model, fmap, gmaps[k], net_c, inp_c)
        admit = dmag > thresh
        fmap = torch.where(admit, gmaps[k].to(fmap.dtype), fmap)
        net_c = torch.where(admit, nets[k], net_c)
        inp_c = torch.where(admit, inps[k], inp_c)
        admits.append(admit)
        dmags.append(dmag)
    pack = torch.cat([torch.stack(admits).float(), torch.stack(dmags)])
    return pack, gmaps, nets, inps


class MotionFilter:
    def __init__(self, model, video, cfg, mono_fn=None):
        self.model = model
        self.video = video
        self.thresh = cfg["tracking"]["motion_filter"]["thresh"]
        self.oracle = cfg["tracking"].get("oracle", False)
        self.mono_fn = mono_fn      # (tstamp, image) -> full-res depth or None
        self.count = 0
        self.fmap = None            # of the last keyframe
        self.net = None
        self.inp = None
        self._last_gt = None        # (pose7, disp) of the last keyframe
        self.timers = PhaseTimers()  # replaced by SLAM's shared timers

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
        with self.timers("mf.mono"):
            mono = self.mono_fn(tstamp, image) if self.mono_fn else None
        return None if mono is None else _disp8_np(mono, self.video.down,
                                                   h8, w8)

    def _enc_flops(self):
        """FLOPs of one encoder pass (JAX motion_filter.py:292-296): ≈ 8 kF
        per input pixel; one update step is ≈ 2.8 MF per 1/8-res pixel."""
        return float(self.video.H * self.video.W) * 8e3

    def decide_batch(self, images_u8, n):
        """The admission scan over a chunk (C,H,W,3) of which the first `n`
        frames count (a padded tail's decisions are discarded). Returns
        (admits[n] bool, deltas[n], gmaps, nets, inps); the maps stay on
        the device for commit_batch_frame. One host pull for the chunk."""
        pack, gmaps, nets, inps = admission_scan(
            self.model, images_u8, self.fmap, self.net, self.inp,
            float(self.thresh))
        C = gmaps.shape[0]
        # JAX motion_filter.py:242-244: both encoders and one update step
        # per frame of the chunk
        h8 = self.video.H // self.video.down
        w8 = self.video.W // self.video.down
        self.video.flops_tracking += C * (2 * self._enc_flops()
                                          + h8 * w8 * 2.8e6)
        small = pack.cpu().numpy()      # the chunk's single device pull
        return small[:C][:n] > 0.5, small[C:][:n], gmaps, nets, inps

    def commit_batch_frame(self, k, batch, tstamp, images_u8, intrinsics,
                           gt_pose=None, gt_depth=None):
        """Admit frame k of a decide_batch chunk: the last-keyframe state
        moves to the scan's row k and the frame is appended to the video —
        the bookkeeping of track()'s admitted branch."""
        _, _, gmaps, nets, inps = batch
        down = self.video.down
        h8, w8 = self.video.H // down, self.video.W // down
        intr8 = np.asarray(intrinsics, np.float32) / float(down)
        gt_disp8 = (_disp8_np(gt_depth, down, h8, w8)
                    if gt_depth is not None else None)
        self.count = 0
        self.fmap, self.net, self.inp = gmaps[k], nets[k], inps[k]
        image = images_u8[k]
        mono = self._mono(tstamp, image, h8, w8)
        with self.timers("mf.append"):
            self.video.append(tstamp, _img255(image), None, None, mono,
                              intr8, self.fmap, self.net, self.inp,
                              gt_pose=gt_pose, gt_depth=gt_disp8)

    def track(self, tstamp, image, intrinsics, gt_pose=None, gt_depth=None):
        """image (H,W,3) uint8 or float [0,1]; intrinsics (4,) full-res;
        gt_pose (7,) w2c and gt_depth (H,W) feed the oracle slots.
        Returns True when the frame was admitted as a keyframe."""
        T = self.timers
        down = self.video.down
        intr8 = np.asarray(intrinsics, np.float32) / float(down)
        h8, w8 = self.video.H // down, self.video.W // down
        gt_disp8 = (_disp8_np(gt_depth, down, h8, w8)
                    if gt_depth is not None else None)
        oracle_gated = (self.oracle and self.video.counter > 0
                        and gt_pose is not None
                        and self._last_gt is not None)
        gmap = delta_mag = None
        # the FLOP counts of JAX motion_filter.py:300, 305, 345, 348
        enc_f = self._enc_flops()
        if self.video.counter == 0 or (self.oracle and not oracle_gated):
            with T("mf.encode_f"):
                gmap = encode_features(self.model, image)
                self.video.flops_tracking += enc_f
        elif not self.oracle:
            with T("mf.track_kernel"):
                gmap, delta_mag = track_kernel(self.model, image, self.fmap,
                                               self.net, self.inp)
                self.video.flops_tracking += enc_f + h8 * w8 * 2.8e6
        # oracle_gated: admission needs only GT flow; the features are
        # encoded below, only for admitted keyframes

        if self.video.counter == 0:
            net, inp = encode_context(self.model, image)
            self.fmap, self.net, self.inp = gmap, net, inp
            self.video.append(
                tstamp, _img255(image), lie.identity().numpy(), 1.0,
                self._mono(tstamp, image, h8, w8), intr8, gmap, net, inp,
                gt_pose=gt_pose, gt_depth=gt_disp8)
            if self.oracle and gt_pose is not None:
                d0 = gt_disp8 if gt_disp8 is not None else \
                    np.ones((h8, w8), np.float32)
                self._last_gt = (np.asarray(gt_pose), d0)
            return True

        disp = None
        if oracle_gated:
            with T("mf.oracle_flow"):
                delta, disp = self._oracle_flow(gt_pose, gt_disp8, intr8)
        elif delta_mag is not None:
            delta = float(delta_mag)
        else:
            # oracle mode with no GT signal for this frame: admit rather
            # than lose track
            delta = float("inf")
        if delta > self.thresh:
            self.count = 0
            if gmap is None:
                with T("mf.encode_f"):
                    gmap = encode_features(self.model, image)
                    self.video.flops_tracking += enc_f
            with T("mf.encode_c"):
                net, inp = encode_context(self.model, image)
                self.video.flops_tracking += enc_f
            self.fmap, self.net, self.inp = gmap, net, inp
            mono = self._mono(tstamp, image, h8, w8)
            with T("mf.append"):
                self.video.append(
                    tstamp, _img255(image), None, None, mono, intr8, gmap,
                    net, inp, gt_pose=gt_pose, gt_depth=gt_disp8)
            if self.oracle and gt_pose is not None:
                d1 = disp if disp is not None else \
                    np.ones((h8, w8), np.float32)
                self._last_gt = (np.asarray(gt_pose), d1)
            return True
        self.count += 1
        return False
