"""Monocular depth prior providers (counterpart of
splatslam_tpu/mono_prior.py).

This slice carries two providers:
  * "oracle" — dataset GT depth with a fixed affine distortion in
               disparity (the tracker must recover w = 2, q = −0.4);
  * "none"   — no prior.
"files" and "dpt" are not ported yet and fail loudly.

A provider returns a full-resolution (H, W) float32 depth map or None,
and saves it as `<save_dir>/mono_priors/depths/<idx:05d>.npy` like the
reference.
"""

from __future__ import annotations

import os

import numpy as np

PROVIDERS = ("oracle", "none")


class MonoDepthProvider:
    def __init__(self, cfg, dataset, save_dir):
        self.dataset = dataset
        self.save_dir = save_dir
        mp = cfg.get("mono_prior", {})
        self.kind = mp.get("provider", "oracle" if cfg.get("dataset") ==
                           "synthetic" else "files")
        if self.kind not in PROVIDERS:
            raise NotImplementedError(
                f"mono_prior.provider {self.kind!r}: not ported yet")
        self.save = mp.get("save_depths", True)
        self._cache: dict[int, np.ndarray] = {}

    def _path(self, idx):
        return os.path.join(self.save_dir, "mono_priors", "depths",
                            f"{idx:05d}.npy")

    def __call__(self, idx):
        idx = int(idx)
        if self.kind == "none":
            return None
        if idx in self._cache:
            return self._cache[idx]
        _, _, depth, _ = self.dataset[idx]
        if depth is None:
            return None
        z = np.asarray(depth, np.float32)
        mono_disp = np.where(z > 1e-6, 0.5 / np.maximum(z, 1e-6) + 0.2, 0.0)
        d = np.where(mono_disp > 1e-6, 1.0 / np.maximum(mono_disp, 1e-6),
                     0.0)
        if self.save:
            os.makedirs(os.path.dirname(self._path(idx)), exist_ok=True)
            np.save(self._path(idx), d)
        self._cache[idx] = d
        if len(self._cache) > 64:
            self._cache.pop(next(iter(self._cache)))
        return d
