"""SLAM orchestrator: one host loop driving tracker + mapper (counterpart
of splatslam_tpu/slam.py; reference src/slam.py:34-261 +
src/tracker.py:23-92, whose two processes already run in lock step at
keyframe granularity).

This slice runs oracle tracking (GT-flow targets) end to end: keyframe
admission, DBA/DSPO bundle adjustment, proxy-depth fusion and map
deformation, the windowed 3DGS optimisation, the final BA and refine, and
the kf-ATE, PSNR/SSIM and depth-L1 evaluations. A configuration outside
the slice raises NotImplementedError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import resolve_device
from .datasets import get_dataset
from .mono_prior import MonoDepthProvider, PROVIDERS
from .ops import lie
from .tracking.depth_video import DepthVideo
from .tracking.motion_filter import MotionFilter
from .tracking.frontend import Frontend
from .tracking.backend import Backend
from .mapping.mapper import Mapper
from .mapping.gaussians import save_ply
from .utils.printer import Printer, FontColor
from .utils.eval_traj import kf_traj_eval
from .utils.eval_render import eval_rendering
from .utils.profiling import PhaseTimers


def check_slice(cfg):
    """Fail loudly on a configuration this slice of the port cannot run."""
    if not cfg["tracking"].get("oracle", False):
        raise NotImplementedError("learned tracker: not ported yet")
    provider = cfg.get("mono_prior", {}).get(
        "provider", "oracle" if cfg.get("dataset") == "synthetic"
        else "files")
    if provider not in PROVIDERS:
        raise NotImplementedError(
            f"mono_prior.provider {provider!r}: not ported yet")
    if cfg.get("dataset") != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.get('dataset')!r}: not ported yet")


class SLAM:
    def __init__(self, cfg, device=None, stream=None):
        check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full float32 everywhere (cuDNN convolutions default to TF32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.verbose = cfg.get("verbose", True)
        self.only_tracking = cfg.get("only_tracking", False)
        self.save_dir = os.path.join(cfg["data"]["output"],
                                     str(cfg.get("scene", "scene")))
        os.makedirs(self.save_dir, exist_ok=True)
        self.stream = stream if stream is not None else get_dataset(cfg)
        self.printer = Printer(len(self.stream), self.verbose)
        self.video = DepthVideo(cfg, device=self.device)
        self.mono = MonoDepthProvider(cfg, self.stream, self.save_dir)
        self.motion_filter = MotionFilter(
            self.video, cfg, mono_fn=lambda t, img: self.mono(int(t)))
        self.frontend = Frontend(self.video, cfg)
        self.online_ba = Backend(self.video, cfg)
        self.mapper = None
        if not self.only_tracking:
            self.mapper = Mapper(cfg, self.video, self.stream,
                                 mono_loader=self.mono, printer=self.printer,
                                 device=self.device)
            self.mapper.save_dir = self.save_dir
        self.ba_freq = cfg["tracking"]["backend"]["ba_freq"]
        self.enable_online_ba = cfg["tracking"]["frontend"][
            "enable_online_ba"]
        self.every_kf = cfg["mapping"]["every_keyframe"]
        self.global_scale = 1.0
        self.timers = PhaseTimers(self.device)
        if self.mapper is not None:
            self.mapper.timers = self.timers
        self.frontend.timers = self.timers

    def run(self):
        """Main loop (tracker.py:47-92 + the mapper handshake). Returns the
        results dict of terminate()."""
        intrinsic = np.asarray(self.stream.get_intrinsic(), np.float32)
        prev_kf_idx = prev_ba_idx = number_of_kf = 0
        T = self.timers
        for i in range(len(self.stream)):
            with T("data"):
                timestamp, image, gt_depth, gt_c2w = self.stream[i]
                img_u8 = (np.asarray(image) * 255.0).astype(np.uint8)
                gt_pose = None
                if gt_c2w is not None and np.isfinite(gt_c2w).all():
                    gt_pose = lie.from_matrix_np(np.linalg.inv(gt_c2w))
            with T("motion_filter"):
                self.motion_filter.track(timestamp, img_u8, intrinsic,
                                         gt_pose=gt_pose, gt_depth=gt_depth)
            with T("frontend"):
                self.frontend()
            curr_kf_idx = self.video.counter - 1
            if curr_kf_idx != prev_kf_idx and self.frontend.is_initialized:
                number_of_kf += 1
                if (self.enable_online_ba
                        and curr_kf_idx >= prev_ba_idx + self.ba_freq):
                    self.printer.print(
                        f"Online BA at {curr_kf_idx}th keyframe, frame "
                        f"{timestamp}", FontColor.TRACKER)
                    with T("online_ba"):
                        self.online_ba.dense_ba(2)
                    prev_ba_idx = curr_kf_idx
                if self.mapper is not None and \
                        number_of_kf % self.every_kf == 0:
                    with T("mapping"):
                        self.mapper.process_keyframe(int(timestamp),
                                                     curr_kf_idx)
            prev_kf_idx = curr_kf_idx
            self.printer.update_pbar()
        return self.terminate()

    def backend(self):
        self.printer.print("Final Global BA Triggered!", FontColor.TRACKER)
        ba = Backend(self.video, self.cfg)
        ba.dense_ba(7)
        ba.dense_ba(12)
        self.printer.print("Final Global BA Done!", FontColor.TRACKER)

    def terminate(self):
        """Final BA → save → trajectory eval → refine → render eval →
        depth eval (slam.py:130-244)."""
        cfg = self.cfg
        T = self.timers
        res = dict(n_frames=len(self.stream), n_keyframes=self.video.counter,
                   ate_rmse=None, psnr=None, ssim=None, depth_l1=None,
                   proxy_depth_l1=None)
        if cfg["tracking"]["backend"]["final_ba"]:
            with T("final_ba"):
                self.backend()

        npz = os.path.join(self.save_dir, "video.npz")
        with T("save_video"):
            self.video.save_video(npz)
        ate_stats = None
        try:
            with T("kf_traj_eval"):
                ate_stats, self.global_scale, _, _ = kf_traj_eval(
                    npz, os.path.join(self.save_dir, "traj"), "kf_traj",
                    self.stream, self.printer)
            res["ate_rmse"] = ate_stats["rmse"]
        except Exception as e:  # graceful like slam.py:175-176
            self.printer.print(str(e), FontColor.ERROR)

        if self.mapper is not None:
            if cfg["tracking"]["backend"]["final_ba"]:
                with T("final_refine"):
                    self.mapper.final_refine(
                        iters=cfg["mapping"]["final_refine_iters"])
            with T("render_eval"):
                r = eval_rendering(self.mapper, self.save_dir, self.stream,
                                   global_scale=self.global_scale,
                                   iteration="after_refine",
                                   printer=self.printer)
            res.update(psnr=r["mean_psnr"], ssim=r["mean_ssim"],
                       depth_l1=r["mean_depth_l1"])
            if cfg.get("meshing", {}).get("mesh", False):
                self.printer.print("mesh eval: not ported yet, skipped",
                                   FontColor.EVAL)
            save_ply(self.mapper.st,
                     os.path.join(self.save_dir, "gaussians.ply"))

        try:
            with T("depth_eval"):
                d_l1, d_l1_4m, cover = self.video.eval_depth_l1(
                    npz, self.stream)
            with open(os.path.join(self.save_dir, "depth_stats.txt"),
                      "w") as f:
                f.write(f"depth_l1: {d_l1}\n")
                f.write(f"depth_l1_mask_4m: {d_l1_4m}\n")
                f.write(f"Average frame coverage: {cover}\n")
                f.write(f"traj scaling: {self.global_scale}\n")
                f.write(f"traj stats: {ate_stats}\n")
            res["proxy_depth_l1"] = d_l1
            self.printer.print(f"Depth L1: {d_l1:.4f} (4m: {d_l1_4m:.4f}, "
                               f"coverage {cover:.3f})", FontColor.EVAL)
        except Exception as e:
            self.printer.print(f"depth eval failed: {e}", FontColor.ERROR)

        if cfg.get("eval_full_traj", True):
            self.printer.print(
                "full-trajectory eval: needs the learned trajectory filler, "
                "not ported yet — skipped", FontColor.EVAL)

        self.printer.print("Metrics Evaluation Done!", FontColor.EVAL)
        if self.verbose or cfg.get("profiling", {}).get("timers", False):
            self.printer.print("phase timing:\n" + self.timers.report(),
                               FontColor.EVAL)
        self.printer.terminate()
        res["ate_stats"] = ate_stats
        res["timers"] = self.timers.as_dict()
        return res
