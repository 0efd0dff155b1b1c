"""CLI entry point of the PyTorch port (run.py's arguments):

    python -m splatslam_tpu_torch.run configs/Synthetic/smoke_oracle.yaml
    python -m splatslam_tpu_torch.run <config> --device cpu
    python -m splatslam_tpu_torch.run <config> --profile DIR

Runs on the GPU unless `--device` names another device; with no GPU and
no `--device` it raises. Prints the frame count, wall time and FPS.
`--profile DIR` prints the per-phase timers and writes a torch.profiler
trace of the main loop to DIR/trace.json.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="path to config yaml")
    parser.add_argument("--only_tracking", action="store_true",
                        help="run tracking without mapping")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="print per-phase wall timers and write a "
                             "profiler trace of the main loop to "
                             "DIR/trace.json")
    args = parser.parse_args(argv)

    from . import resolve_device
    from .config import load_config, save_config
    from .slam import SLAM

    device = resolve_device(args.device)
    cfg = load_config(args.config, "configs/splat_slam.yaml"
                      if os.path.exists("configs/splat_slam.yaml") else None)
    seed = cfg.get("setup_seed", 43)
    np.random.seed(seed)
    random.seed(seed)
    if args.only_tracking:
        cfg["only_tracking"] = True
        cfg.setdefault("mono_prior", {})["predict_online"] = True
    if args.profile:
        cfg.setdefault("profiling", {})["trace_dir"] = args.profile
        cfg["profiling"]["timers"] = True

    out_dir = os.path.join(cfg["data"]["output"],
                           str(cfg.get("scene", "scene")))
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))

    t0 = time.time()
    slam = SLAM(cfg, device=device)
    res = slam.run()
    dt = time.time() - t0
    n = len(slam.stream)
    print(f"\nDone: {n} frames in {dt:.1f}s ({n / dt:.2f} FPS)")
    return res


if __name__ == "__main__":
    main()
