"""Learned-tracking ATE ablation matrix on the bench scene (the port's
counterpart of tools/ate_matrix.py; same arms and printed lines).

Runs only-tracking arms of the full pipeline (configs/Synthetic/smoke.yaml,
60 frames, 240x320) with one knob changed per arm and prints each arm's
kf-ATE: checkpoint quality against BA configuration against admission
density against online and loop BA. `SPLATSLAM_CKPT` names another tracker
checkpoint for every arm.

Usage: python -m splatslam_tpu_torch.tools.ate_matrix [arm ...]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from ..config import load_config

ARMS = {
    "base": {},
    "noba": {("tracking", "frontend", "enable_online_ba"): False,
             ("tracking", "frontend", "enable_loop"): False},
    "dba": {("tracking", "backend", "BA_type"): "DBA"},
    "sparse": {("tracking", "motion_filter", "thresh"): 1.8},
    "dense": {("tracking", "motion_filter", "thresh"): 1.0},
    "iters16": {"_iters": (16, 8)},
    "nonorm": {("tracking", "backend", "normalize"): False},
    # the reference's online-BA cadence (splat_slam.yaml ba_freq 20 against
    # the smoke override 10) with admission matched to oracle density
    "ref_cadence": {("tracking", "backend", "ba_freq"): 20,
                    ("tracking", "motion_filter", "thresh"): 1.6},
    "loop_only": {("tracking", "frontend", "enable_online_ba"): False,
                  ("tracking", "motion_filter", "thresh"): 1.6},
    "t16": {("tracking", "motion_filter", "thresh"): 1.6},
}
OUT = os.path.join("output", "ate_matrix")


def base_cfg():
    cfg = load_config("configs/Synthetic/smoke.yaml",
                      "configs/splat_slam.yaml")
    ck = os.environ.get("SPLATSLAM_CKPT")
    if ck:
        cfg["tracking"]["pretrained"] = ck
    cfg["verbose"] = False
    cfg["only_tracking"] = True
    cfg["max_frames"] = 60
    cfg["synthetic"]["n_frames"] = 60
    cfg["eval_full_traj"] = False
    cfg["eval_plots"] = False
    return cfg


def arm_cfg(name, overrides, cfg=None, out=OUT):
    """The arm's configuration (from base_cfg() unless `cfg` is given) and
    its frontend iterations (iters1, iters2) or None."""
    cfg = base_cfg() if cfg is None else cfg
    cfg["data"]["output"] = os.path.join(out, name)
    iters = None
    for k, v in overrides.items():
        if k == "_iters":
            iters = v
            continue
        d = cfg
        for part in k[:-1]:
            d = d[part]
        d[k[-1]] = v
    return cfg, iters


def run_arm(name, overrides, device=None, cfg=None, out=OUT):
    """One arm through the port's SLAM: (kf-ATE RMSE, keyframes). Prints
    the tool's ARM line."""
    from ..slam import SLAM
    cfg, iters = arm_cfg(name, overrides, cfg, out)
    slam = SLAM(cfg, device=device)
    if iters is not None:
        slam.frontend.iters1, slam.frontend.iters2 = iters
    rmse = slam.run()["ate_rmse"]
    n_kf = slam.video.counter
    print(f"ARM {name:8s} kf_ate {rmse}  n_kf {n_kf}", flush=True)
    return rmse, n_kf


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arms", nargs="*", help=f"arms (default: all of "
                    f"{', '.join(ARMS)})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    device = resolve_device(args.device)
    res = {}
    for a in args.arms or list(ARMS):
        try:
            res[a] = run_arm(a, ARMS[a], device=device)
        except Exception as e:   # one arm's failure is that arm's line
            print(f"ARM {a:8s} FAILED {type(e).__name__}: {e}", flush=True)
    return res


if __name__ == "__main__":
    main()
