"""State carried across from the JAX package: its GaussianState and
VideoState as dicts of numpy arrays (same field names) into the port's
states, and its DroidNet parameter tree into the port's network, so a run
or a test can continue from a JAX map, video and tracker."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .mapping.gaussians import GaussianState
from .tracking.depth_video import VideoState


# the video's network fields: channel-last in the JAX package, channel-first
# here (tracking/depth_video.py); fmaps are bf16 in both
_NHWC_FIELDS = ("fmaps", "nets", "inps")


def _fields(cls, d, device):
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            raise KeyError(f"{cls.__name__}: missing field {f.name!r}")
        a = np.asarray(d[f.name])
        if a.dtype.name == "bfloat16":       # numpy has no bf16 of its own
            a = a.astype(np.float32)
        t = torch.as_tensor(np.array(a), device=device)
        if cls is VideoState and f.name in _NHWC_FIELDS:
            t = t.permute(0, 3, 1, 2).contiguous()
            if f.name == "fmaps":
                t = t.to(torch.bfloat16)
        out[f.name] = t
    return cls(**out)


def gaussian_state_from_numpy(d: dict, device=None) -> GaussianState:
    """Parameters, Adam moments, alive mask and statistics of a JAX
    GaussianState (numpy arrays keyed by field name). `device` None is the
    GPU (resolve_device)."""
    return _fields(GaussianState, d, device)


def video_state_from_numpy(d: dict, device=None) -> VideoState:
    """A JAX VideoState (numpy arrays keyed by field name); its network
    fields (fmaps, nets, inps) go from (B,h,w,128) to (B,128,h,w)."""
    return _fields(VideoState, d, device)


def droid_params_from_numpy(tree: dict) -> dict:
    """A flax DroidNet parameter tree (nested dicts of numpy arrays,
    kernels HWIO) → the port's DroidNet `state_dict` (OIHW, the reference
    checkpoint's names), for `DroidNet.load_state_dict`."""
    from .models.weights import flax_tree_to_state_dict
    return flax_tree_to_state_dict(tree)
