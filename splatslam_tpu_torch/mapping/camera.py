"""Per-keyframe camera state for the mapper (counterpart of
splatslam_tpu/mapping/camera.py; reference
thirdparty/monogs/utils/camera_utils.py:13-148). The image and proxy depth
are tensors on the run's device; the pose is a host 4×4 (the keyframe
window logic reads it many times per keyframe)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass
class Camera:
    uid: int
    image: torch.Tensor              # (H, W, 3) float [0, 1]
    depth: torch.Tensor | None       # (H, W) proxy depth
    w2c: np.ndarray                  # (4, 4) current estimate
    w2c_gt: np.ndarray               # (4, 4) from the tracker


def make_camera(uid, image, depth, w2c, device=None):
    """`device` None is the GPU (resolve_device)."""
    device = resolve_device(device)
    # w2c_gt gets its own copy: an in-place w2c edit must not reach it
    image = torch.as_tensor(np.asarray(image), dtype=torch.float32,
                            device=device)
    if depth is not None:
        depth = torch.as_tensor(depth, dtype=torch.float32, device=device)
    return Camera(uid=uid, image=image, depth=depth, w2c=np.asarray(w2c),
                  w2c_gt=np.array(w2c))
