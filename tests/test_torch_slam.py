"""The whole system end to end: `python -m splatslam_tpu_torch.run`'s main at
--device cpu against the JAX package's SLAM on the same shrunk smoke
configuration (96×128, 12 frames, capacity 4096, K=32, a few mapping
iterations), once with oracle tracking and once, at 96×136, with the
learned tracker (the in-repo checkpoint, both networks in float32) and the
full-trajectory evaluation.

Both runs record SLAM.run's on_frame hook: the same (frame index,
timestamp, newest keyframe index) after every frame, per frame (oracle) and
through the chunked admission (learned). Tracking is deterministic, so the
admitted keyframes must match exactly,
and kf-ATE within 1e-3 (learned: measured gap 1.6e-4; full-trajectory ATE
within 3e-3, measured 7.9e-4 — 12 more network rounds per frame). The
mapper's random draws (anchor subsampling, split noise) come from
jax.random in one package and torch.Generator in the other, so PSNR and the
depth L1s are held to a band instead: 1.5 dB and 0.05 m at this size.
"""

import json
import os

import numpy as np
import pytest
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(out_dir, learned=False):
    from splatslam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    cfg.pop("inherit_from", None)
    cfg.update(max_frames=12, verbose=False, eval_full_traj=False,
               eval_plots=False, scene="tiny")
    cfg["synthetic"]["n_frames"] = 12
    cfg["cam"].update(H=96, W=128, fx=80.0, fy=80.0, cx=63.5, cy=47.5,
                      H_out=96, W_out=128)
    cfg["data"]["output"] = str(out_dir)
    cfg["meshing"]["mesh"] = False
    m = cfg["mapping"]
    m.update(capacity=4096, raster_K=32, final_refine_iters=24,
             pcd_downsample=8, pcd_downsample_init=4)
    m["Training"].update(init_itr_num=40, init_gaussian_update=20,
                         init_gaussian_reset=1000, mapping_itr_num=10,
                         window_size=4)
    tr = cfg["tracking"]
    tr.update(buffer=16, pretrained="")
    tr["motion_filter"]["thresh"] = 0.4
    tr["frontend"].update(keyframe_thresh=0.25, window=8)
    if learned:
        # buffer 24: the trajectory filler parks a 12-frame batch behind
        # the keyframes. 96×136: no other test traces the JAX programs at
        # this size, so the float32 ones compiled here (SPLATSLAM_F32_NET is
        # read at trace time) are this test's own and nobody else's.
        tr.update(oracle=False, buffer=24)
        cfg["cam"].update(W=136, W_out=136, cx=67.5)
        cfg["eval_full_traj"] = True
    return cfg


def _hook(frames):
    return lambda i, ts, kf: frames.append((int(i), float(ts), int(kf)))


def _record_port_frames(monkeypatch):
    """Every port SLAM.run in this test records its on_frame calls into the
    returned list."""
    from splatslam_tpu_torch.slam import SLAM
    frames = []
    run = SLAM.run
    monkeypatch.setattr(SLAM, "run",
                        lambda self: run(self, on_frame=_hook(frames)))
    return frames


def _run_jax(cfg):
    from splatslam_tpu.slam import SLAM
    slam = SLAM(cfg)
    frames = []
    ate = slam.run(on_frame=_hook(frames))
    save = slam.save_dir
    with open(os.path.join(save, "rendering", "after_refine",
                           "final_result.json")) as f:
        r = json.load(f)
    with open(os.path.join(save, "depth_stats.txt")) as f:
        proxy = float(f.readline().split(":")[1])
    out = dict(n_keyframes=slam.video.counter, ate_rmse=ate["rmse"],
               psnr=r["mean_psnr"], depth_l1=r["mean_depth_l1"],
               proxy_depth_l1=proxy, frames=frames,
               kf_stamps=np.asarray(slam.video.state.timestamp[
                   :slam.video.counter]).tolist())
    full = os.path.join(save, "traj", "metrics_full_traj.txt")
    if os.path.exists(full):
        with open(full) as f:
            out["full_ate_rmse"] = json.load(f)["rmse"]
    return out


def test_oracle_slam_matches_jax(tmp_path, monkeypatch):
    import yaml
    from splatslam_tpu_torch import run
    monkeypatch.chdir(REPO)
    cfg_t = _cfg(tmp_path / "torch")
    path = tmp_path / "tiny.yaml"
    with open(path, "w") as f:
        yaml.dump(cfg_t, f)
    frames = _record_port_frames(monkeypatch)
    got = run.main([str(path), "--device", "cpu"])
    want = _run_jax(_cfg(tmp_path / "jax"))
    print("port", {k: got[k] for k in want if k in got}, "jax", want)
    assert frames == want["frames"]
    assert [f[0] for f in frames] == list(range(12))
    assert got["n_keyframes"] == want["n_keyframes"] >= 5
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-3
    assert np.isfinite(got["psnr"]) and abs(got["psnr"] - want["psnr"]) <= 1.5
    assert abs(got["depth_l1"] - want["depth_l1"]) <= 0.05
    assert abs(got["proxy_depth_l1"] - want["proxy_depth_l1"]) <= 0.05
    assert os.path.exists(tmp_path / "torch" / "tiny" / "gaussians.ply")


def test_learned_slam_matches_jax(tmp_path, monkeypatch):
    """tracking.oracle False: learned admission (per-frame, then chunked),
    learned frontend rounds, final BA, mapping, refine, every evaluation
    and the trajectory filler, in both packages."""
    import yaml
    from splatslam_tpu_torch import run
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("SPLATSLAM_F32_NET", "1")
    cfg_t = _cfg(tmp_path / "torch", learned=True)
    path = tmp_path / "tiny.yaml"
    with open(path, "w") as f:
        yaml.dump(cfg_t, f)
    frames = _record_port_frames(monkeypatch)
    got = run.main([str(path), "--device", "cpu"])
    want = _run_jax(_cfg(tmp_path / "jax", learned=True))
    assert frames == want["frames"]
    assert [f[0] for f in frames] == list(range(12))
    keys = ("n_keyframes", "ate_rmse", "full_ate_rmse", "psnr", "depth_l1",
            "proxy_depth_l1")
    print("port", {k: got[k] for k in keys}, "jax", {k: want[k] for k in keys})
    assert got["weights"] == "pretrained/droid_dba.msgpack"
    save = tmp_path / "torch" / "tiny"
    with np.load(save / "video.npz") as d:
        assert d["timestamps"].tolist() == want["kf_stamps"]
    assert got["n_keyframes"] == want["n_keyframes"] >= 5
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-3
    assert abs(got["full_ate_rmse"] - want["full_ate_rmse"]) <= 3e-3
    assert np.isfinite(got["psnr"]) and abs(got["psnr"] - want["psnr"]) <= 1.5
    assert abs(got["depth_l1"] - want["depth_l1"]) <= 0.05
    assert abs(got["proxy_depth_l1"] - want["proxy_depth_l1"]) <= 0.05
    for name in ("traj/metrics_kf_traj.txt", "traj/metrics_full_traj.txt",
                 "rendering/after_refine/final_result.json", "gaussians.ply"):
        assert os.path.exists(save / name), name
