"""SLAM orchestrator: one host loop driving tracker + mapper (counterpart
of splatslam_tpu/slam.py; reference src/slam.py:34-261 +
src/tracker.py:23-92, whose two processes already run in lock step at
keyframe granularity).

Runs the learned tracker (DroidNet admission and update rounds) or, with
`tracking.oracle`, GT-flow targets, end to end: keyframe admission,
DBA/DSPO bundle adjustment, loop closure, proxy-depth fusion and map
deformation, the windowed 3DGS optimisation, the final BA and refine, and
the kf-ATE, PSNR/SSIM, depth-L1, mesh and full-trajectory evaluations, on
the procedural Synthetic scene or a Replica / ScanNet / TUM-RGBD tree, with
any mono prior provider. The one configuration the port cannot run yet,
mapping over several devices, raises NotImplementedError.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from . import resolve_device
from .datasets import get_dataset
from .models.weights import load_droid_params
from .mono_prior import MonoDepthProvider
from .ops import lie
from .tracking.depth_video import DepthVideo
from .tracking.motion_filter import MotionFilter
from .tracking.frontend import Frontend
from .tracking.backend import Backend
from .tracking.trajectory_filler import PoseTrajectoryFiller
from .mapping.mapper import Mapper
from .mapping.gaussians import save_ply
from .utils.printer import Printer, FontColor
from .utils.eval_traj import kf_traj_eval, full_traj_eval
from .utils.eval_render import eval_rendering, eval_mesh
from .utils.profiling import PhaseTimers


def check_slice(cfg):
    """Fail loudly on a configuration the port cannot run yet: camera
    batches sharded over several devices (`mapping.mesh_devices` > 1)."""
    n_mesh = int(cfg.get("mapping", {}).get("mesh_devices", 0) or 0)
    if n_mesh > 1:
        raise NotImplementedError(f"mapping.mesh_devices {n_mesh}: "
                                  "multi-GPU mapping is not ported yet")


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
        self.mono = MonoDepthProvider(cfg, self.stream, self.save_dir,
                                      device=self.device)
        # the tracker network, loaded once and shared by its four consumers
        self.model = load_droid_params(
            cfg["tracking"].get("pretrained", ""), device=self.device)
        self.motion_filter = MotionFilter(
            self.model, self.video, cfg,
            mono_fn=lambda t, img: self._prior(t))
        self.frontend = Frontend(self.model, self.video, cfg)
        self.online_ba = Backend(self.model, self.video, cfg)
        self.traj_filler = PoseTrajectoryFiller(self.model, self.video)
        self.mapper = None
        if not self.only_tracking:
            self.mapper = Mapper(cfg, self.video, self.stream,
                                 mono_loader=self._prior, printer=self.printer,
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
        self.motion_filter.timers = self.timers

    def _prior(self, idx):
        """The mono prior of frame `idx`, timed as phase "mono" (it runs
        inside the "motion_filter" and "mapping" phases)."""
        with self.timers("mono"):
            return self.mono(int(idx))

    def run(self):
        """Main loop (tracker.py:47-92 + the mapper handshake). Returns the
        results dict of terminate().

        Frames come from a one-frame-lookahead prefetch thread: decoding or
        rendering a frame is host numpy and would otherwise run serially
        with the device's tracking work (the reference gets this overlap
        from its process split, tracker.py:64 + datasets.py:170-216)."""
        oracle = self.cfg["tracking"].get("oracle", False)
        chunk = 1 if oracle else int(
            self.cfg["tracking"]["motion_filter"].get("batch", 8))
        stream = self.stream

        def prefetch(q, stop):
            try:
                for k in range(len(stream)):
                    if stop.is_set():
                        break
                    timestamp, image, gt_depth, gt_c2w = stream[k]
                    img_u8 = (np.asarray(image) * 255.0).astype(np.uint8)
                    # GT reaches the tracker in oracle mode only
                    gt_pose = None
                    if oracle and gt_c2w is not None \
                            and np.isfinite(gt_c2w).all():
                        gt_pose = lie.from_matrix_np(np.linalg.inv(gt_c2w))
                    q.put((k, (timestamp, img_u8,
                               gt_depth if oracle else None, gt_pose)))
            except Exception as e:       # raised again by the consumer
                q.put((-1, e))
            q.put(None)

        # the queue covers one admission chunk plus the lookahead
        pre_q = queue.Queue(maxsize=2 if oracle else 2 + chunk)
        stop = threading.Event()
        threading.Thread(target=prefetch, args=(pre_q, stop),
                         daemon=True).start()
        try:
            self._run_loop(pre_q, chunk)
        finally:
            stop.set()
            while not pre_q.empty():     # unblock the producer
                try:
                    pre_q.get_nowait()
                except queue.Empty:
                    break
        return self.terminate()

    def _post_frame(self, timestamp):
        """After a frame's admission decision: frontend, online BA and
        mapping when a keyframe came in."""
        T = self.timers
        with T("frontend"):
            self.frontend()
        curr_kf_idx = self.video.counter - 1
        if curr_kf_idx != self._prev_kf_idx and self.frontend.is_initialized:
            self._number_of_kf += 1
            if (self.enable_online_ba
                    and curr_kf_idx >= self._prev_ba_idx + self.ba_freq):
                self.printer.print(
                    f"Online BA at {curr_kf_idx}th keyframe, frame "
                    f"{timestamp}", FontColor.TRACKER)
                with T("online_ba"):
                    self.online_ba.dense_ba(2)
                self._prev_ba_idx = curr_kf_idx
            if self.mapper is not None and \
                    self._number_of_kf % self.every_kf == 0:
                with T("mapping"):
                    self.mapper.process_keyframe(int(timestamp), curr_kf_idx)
        self._prev_kf_idx = curr_kf_idx
        self.printer.update_pbar()

    def _run_loop(self, pre_q, chunk):
        """Per frame until the first keyframe exists and in oracle mode;
        else in chunks of `chunk` frames whose admission is decided with
        one host pull (motion_filter.admission_scan). Keyframe appends stay
        interleaved with the frontend, so pose and disparity seeding sees
        the order of the per-frame path."""
        intrinsic = np.asarray(self.stream.get_intrinsic(), np.float32)
        self._prev_kf_idx = self._prev_ba_idx = self._number_of_kf = 0
        T = self.timers
        mf = self.motion_filter
        n = len(self.stream)
        i, done = 0, False
        while i < n and not done:
            take = chunk if self.video.counter > 0 else 1
            items = []
            with T("data"):
                for _ in range(min(take, n - i)):
                    item = pre_q.get()
                    if item is None:
                        done = True
                        break
                    if item[0] == -1:
                        raise item[1]
                    items.append(item)
            if not items:
                break
            if len(items) == 1:
                idx, (timestamp, img_u8, gt_depth, gt_pose) = items[0]
                with T("motion_filter"):
                    mf.track(timestamp, img_u8, intrinsic, gt_pose=gt_pose,
                             gt_depth=gt_depth)
                self._post_frame(timestamp)
                i = idx + 1
                continue
            with T("motion_filter"):
                with T("mf.track_kernel"):
                    imgs = torch.as_tensor(
                        np.stack([it[1][1] for it in items]),
                        device=self.device)
                    batch = mf.decide_batch(imgs, len(items))
            for k, (idx, (timestamp, _, _, gt_pose)) in enumerate(items):
                if batch[0][k]:
                    with T("motion_filter"):
                        mf.commit_batch_frame(k, batch, timestamp, imgs,
                                              intrinsic, gt_pose=gt_pose)
                else:
                    mf.count += 1
                self._post_frame(timestamp)
            i = items[-1][0] + 1

    def backend(self):
        self.printer.print("Final Global BA Triggered!", FontColor.TRACKER)
        ba = Backend(self.model, self.video, self.cfg)
        ba.dense_ba(7)
        ba.dense_ba(12)
        self.printer.print("Final Global BA Done!", FontColor.TRACKER)

    def terminate(self):
        """Final BA → save → trajectory eval → refine → render eval →
        depth eval (slam.py:130-244)."""
        cfg = self.cfg
        T = self.timers
        res = dict(n_frames=len(self.stream), n_keyframes=self.video.counter,
                   ate_rmse=None, full_ate_rmse=None, psnr=None, ssim=None,
                   depth_l1=None, proxy_depth_l1=None, mesh=None,
                   weights=self.model.weights_source)
        plots = cfg.get("eval_plots", True)
        traj_dir = os.path.join(self.save_dir, "traj")
        # optional evaluation before the final BA (slam.py:133-164)
        if (cfg["tracking"]["backend"]["final_ba"]
                and cfg["mapping"].get("eval_before_final_ba", False)
                and self.mapper is not None):
            npz0 = os.path.join(self.save_dir, "video_before_ba.npz")
            self.video.save_video(npz0)
            try:
                _, scale0, _, _ = kf_traj_eval(
                    npz0, traj_dir, "kf_traj_before_ba", self.stream,
                    self.printer, plot=plots)
                eval_rendering(self.mapper, self.save_dir, self.stream,
                               global_scale=scale0,
                               iteration="before_refine",
                               printer=self.printer, save_panels=plots)
            except Exception as e:
                self.printer.print(str(e), FontColor.ERROR)

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
                    npz, traj_dir, "kf_traj", self.stream, self.printer,
                    plot=plots)
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
                                   printer=self.printer, save_panels=plots)
            res.update(psnr=r["mean_psnr"], ssim=r["mean_ssim"],
                       depth_l1=r["mean_depth_l1"])
            if cfg.get("meshing", {}).get("mesh", False):
                try:
                    with T("mesh_eval"):
                        res["mesh"] = eval_mesh(
                            self.mapper, self.save_dir,
                            global_scale=self.global_scale,
                            gt_mesh_path=cfg["meshing"].get(
                                "gt_mesh_path", ""),
                            printer=self.printer)
                except Exception as e:
                    self.printer.print(f"mesh eval failed: {e}",
                                       FontColor.ERROR)
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
            try:
                with T("full_traj_eval"):
                    _, full_stats = full_traj_eval(
                        self.traj_filler, traj_dir, "full_traj", self.stream,
                        self.printer, plot=plots)
                res["full_ate_rmse"] = full_stats["rmse"]
            except Exception as e:
                self.printer.print(f"full traj eval failed: {e}",
                                   FontColor.ERROR)

        self.printer.print("Metrics Evaluation Done!", FontColor.EVAL)
        if self.verbose or cfg.get("profiling", {}).get("timers", False):
            self.printer.print("phase timing:\n" + self.timers.report(),
                               FontColor.EVAL)
        self.printer.terminate()
        res["ate_stats"] = ate_stats
        res["timers"] = self.timers.as_dict()
        return res
