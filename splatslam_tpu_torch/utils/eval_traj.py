"""Trajectory evaluation: Sim(3) Umeyama alignment + APE statistics
(counterpart of splatslam_tpu/utils/eval_traj.py; replaces the reference's
`evo` dependency, src/utils/eval_traj.py:20-175). Host numpy.

The trajectory figure of the JAX package is not produced here (panels are
not ported yet); the metrics file and the aligned trajectory are.
"""

from __future__ import annotations

import json
import os

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale=True):
    """Least-squares similarity transform aligning x (3,N) onto y (3,N):
    (r (3,3), t (3,), c) with y ≈ c·r @ x + t."""
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    sigma_x = max((xc ** 2).sum() / n, 1e-12)
    U, D, Vt = np.linalg.svd(yc @ xc.T / n)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    r = U @ S @ Vt
    c = float(np.trace(np.diag(D) @ S) / sigma_x) if with_scale else 1.0
    t = (my - c * r @ mx)[:, 0]
    return r, t, c


def ape_stats(est_xyz: np.ndarray, gt_xyz: np.ndarray, correct_scale=True):
    """Translational APE after Sim(3)/SE(3) alignment of (N,3) positions:
    (stats dict, (r, t, s))."""
    r, t, s = umeyama_alignment(est_xyz.T, gt_xyz.T, with_scale=correct_scale)
    aligned = (s * (r @ est_xyz.T) + t[:, None]).T
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    stats = {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "sse": float((err ** 2).sum()),
    }
    return stats, (r, t, s)


def _gt_c2w_list(stream, timestamps):
    poses, keep = [], []
    get = getattr(stream, "get_gt_pose", None)
    for i, ts in enumerate(timestamps):
        pose = get(int(ts)) if get is not None else stream[int(ts)][3]
        if pose is None or not np.isfinite(pose).all():
            continue  # NaN GT poses are skipped (eval_traj.py:31-33)
        poses.append(np.asarray(pose, np.float64))
        keep.append(i)
    return poses, keep


def kf_traj_eval(npz_path, traj_dir, name, stream, printer=None):
    """Keyframe ATE from a saved video.npz (eval_traj.py:113-140).
    Returns (stats, global_scale, r_a, t_a)."""
    data = np.load(npz_path)
    c2w = data["poses"]
    gt, keep = _gt_c2w_list(stream, data["timestamps"])
    est_xyz = c2w[keep][:, :3, 3]
    gt_xyz = np.stack([g[:3, 3] for g in gt])
    stats, (r, t, s) = ape_stats(est_xyz, gt_xyz, correct_scale=True)
    os.makedirs(traj_dir, exist_ok=True)
    with open(os.path.join(traj_dir, f"metrics_{name}.txt"), "w") as f:
        f.write(json.dumps(stats, indent=2))
    aligned = (s * (r @ est_xyz.T) + t[:, None]).T
    np.save(os.path.join(traj_dir, f"{name}_aligned.npy"), aligned)
    if printer:
        printer.print(f"kf ate rmse: {stats['rmse']:.4f} (scale {s:.4f})")
    return stats, s, r, t
