"""Trajectory evaluation: Sim(3) Umeyama alignment + APE statistics
(counterpart of splatslam_tpu/utils/eval_traj.py; replaces the reference's
`evo` dependency, src/utils/eval_traj.py:20-175). Host numpy; the
trajectory figure needs matplotlib and is drawn only when `plot` is set.
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


def plot_trajectory(aligned_xyz, gt_xyz, path, title=""):
    """Aligned-vs-GT trajectory figure (reference eval_traj.py:119-140
    writes one per eval via evo's plot module; same content here with
    matplotlib directly: top-down xy track + per-axis error shading)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    err = np.linalg.norm(aligned_xyz - gt_xyz, axis=1)
    fig, (ax0, ax1) = plt.subplots(
        1, 2, figsize=(11, 5), gridspec_kw={"width_ratios": [3, 2]})
    ax0.plot(gt_xyz[:, 0], gt_xyz[:, 1], "k--", lw=1.2, label="ground truth")
    sc = ax0.scatter(aligned_xyz[:, 0], aligned_xyz[:, 1], c=err, s=8,
                     cmap="plasma", label="estimate (Sim3-aligned)")
    fig.colorbar(sc, ax=ax0, label="APE [m]")
    ax0.set_xlabel("x [m]")
    ax0.set_ylabel("y [m]")
    ax0.set_aspect("equal", adjustable="datalim")
    ax0.legend(loc="best", fontsize=8)
    ax0.set_title(title or "trajectory (top-down)")
    ax1.plot(err, lw=1.0)
    ax1.set_xlabel("keyframe")
    ax1.set_ylabel("APE [m]")
    ax1.set_title(f"rmse {np.sqrt((err ** 2).mean()):.4f} m")
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)


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


def kf_traj_eval(npz_path, traj_dir, name, stream, printer=None, plot=True):
    """Keyframe ATE from a saved video.npz (eval_traj.py:113-140); `plot`
    also draws `<name>.png`. Returns (stats, global_scale, r_a, t_a)."""
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
    if plot:
        plot_trajectory(aligned, gt_xyz,
                        os.path.join(traj_dir, f"{name}.png"), title=name)
    if printer:
        printer.print(f"kf ate rmse: {stats['rmse']:.4f} (scale {s:.4f})")
    return stats, s, r, t


def full_traj_eval(traj_filler, traj_dir, name, stream, printer=None,
                   plot=True):
    """Fill the non-keyframe poses, then evaluate every frame
    (eval_traj.py:143-175); `plot` also draws `<name>.png`. Returns
    (c2w (n,4,4), stats)."""
    from ..ops import lie
    c2w = lie.inv_matrix_np(np.asarray(traj_filler(stream)))
    gt, keep = _gt_c2w_list(stream, np.arange(len(stream)))
    est_xyz = c2w[keep][:, :3, 3]
    gt_xyz = np.stack([g[:3, 3] for g in gt])
    stats, (r, t, s) = ape_stats(est_xyz, gt_xyz, correct_scale=True)
    os.makedirs(traj_dir, exist_ok=True)
    with open(os.path.join(traj_dir, f"metrics_{name}.txt"), "w") as f:
        f.write(json.dumps(stats, indent=2))
    if plot:
        aligned = (s * (r @ est_xyz.T) + t[:, None]).T
        plot_trajectory(aligned, gt_xyz,
                        os.path.join(traj_dir, f"{name}.png"), title=name)
    if printer:
        printer.print(f"full ate rmse: {stats['rmse']:.4f}")
    return c2w, stats
