"""Monocular depth prior providers (counterpart of
splatslam_tpu/mono_prior.py; reference src/mono_estimators.py:21-73, which
predicts per keyframe and caches .npy files, plus the offline path,
datasets.py:60-66).

Providers:
  * "files"  — load precomputed `<out>/mono_priors/depths/<idx:05d>.npy`
               (the reference's offline layout);
  * "oracle" — dataset GT depth with a fixed affine distortion in
               disparity (the tracker must recover w = 2, q = −0.4); for
               smoke runs without the omnidata checkpoint;
  * "dpt"    — the omnidata DPT-hybrid network (models/dpt.py) on the run's
               device; an empty `mono_prior.depth_pretrained` draws seeded
               weights, a path that does not exist raises;
  * "none"   — no prior.

A provider returns a full-resolution (H, W) float32 depth map or None, and
saves it as `<save_dir>/mono_priors/depths/<idx:05d>.npy` like the
reference. A saved map is read back on a later call or a later run; the
`.provider` marker beside the maps keeps a run from taking up maps that
another provider wrote.
"""

from __future__ import annotations

import os

import numpy as np

PROVIDERS = ("files", "oracle", "dpt", "none")


class MonoDepthProvider:
    """`device` (None is the GPU) is where the "dpt" network runs; the other
    providers are host code and ignore it."""

    def __init__(self, cfg, dataset, save_dir, device=None):
        self.dataset = dataset
        self.save_dir = save_dir
        mp = cfg.get("mono_prior", {})
        self.kind = mp.get("provider", "oracle" if cfg.get("dataset") ==
                           "synthetic" else "files")
        if self.kind not in PROVIDERS:
            raise ValueError(f"mono_prior.provider {self.kind!r}: expected "
                             f"one of {PROVIDERS}")
        self.save = mp.get("save_depths", True)
        self._dpt = None
        if self.kind == "dpt":
            from .models.dpt import DPTDepthPredictor
            self._dpt = DPTDepthPredictor(
                mp.get("depth_pretrained",
                       "pretrained/omnidata_dpt_depth_v2.ckpt"),
                device=device)
        self._cache: dict[int, np.ndarray] = {}
        # stale-cache guard: .npy files written by an EARLIER run with
        # another provider must not be taken up silently ("files" excepted:
        # there the files are the input)
        self._use_disk = True
        if self.kind not in ("files", "none"):
            marker = os.path.join(self.save_dir, "mono_priors", "depths",
                                  ".provider")
            prev = None
            if os.path.exists(marker):
                with open(marker) as f:
                    prev = f.read().strip()
            if prev is not None and prev != self.kind:
                print(f"[mono_prior] cached depths were produced by "
                      f"provider={prev!r}; recomputing with {self.kind!r}",
                      flush=True)
                self._use_disk = False
            if self.save:
                os.makedirs(os.path.dirname(marker), exist_ok=True)
                with open(marker, "w") as f:
                    f.write(self.kind)

    def _path(self, idx):
        return os.path.join(self.save_dir, "mono_priors", "depths",
                            f"{idx:05d}.npy")

    def __call__(self, idx):
        idx = int(idx)
        if self.kind == "none":
            return None
        if idx in self._cache:
            return self._cache[idx]
        p = self._path(idx)
        if self._use_disk and os.path.exists(p):
            d = np.load(p)
        elif self.kind == "files":
            raise FileNotFoundError(
                f"mono prior not found: {p}. Pre-run the depth predictor or "
                "switch mono_prior.provider.")
        elif self.kind == "oracle":
            _, _, depth, _ = self.dataset[idx]
            if depth is None:
                return None
            z = np.asarray(depth, np.float32)
            mono_disp = np.where(z > 1e-6, 0.5 / np.maximum(z, 1e-6) + 0.2,
                                 0.0)
            d = np.where(mono_disp > 1e-6, 1.0 / np.maximum(mono_disp, 1e-6),
                         0.0)
        else:
            _, color, _, _ = self.dataset[idx]
            d = self._dpt(np.asarray(color))
        if self.save and (not self._use_disk or not os.path.exists(p)):
            os.makedirs(os.path.dirname(p), exist_ok=True)
            np.save(p, d)   # overwrites another provider's stale file
        self._cache[idx] = d
        if len(self._cache) > 64:
            self._cache.pop(next(iter(self._cache)))
        return d
