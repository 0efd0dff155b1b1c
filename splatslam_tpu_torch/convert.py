"""State carried across from the JAX package: its GaussianState and
VideoState as dicts of numpy arrays (same field names) into the port's
states, so a run or a test can continue from a JAX map and video."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .mapping.gaussians import GaussianState
from .tracking.depth_video import VideoState


def _fields(cls, d, device):
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            raise KeyError(f"{cls.__name__}: missing field {f.name!r}")
        out[f.name] = torch.as_tensor(np.array(d[f.name]), device=device)
    return cls(**out)


def gaussian_state_from_numpy(d: dict, device=None) -> GaussianState:
    """Parameters, Adam moments, alive mask and statistics of a JAX
    GaussianState (numpy arrays keyed by field name). `device` None is the
    GPU (resolve_device)."""
    return _fields(GaussianState, d, device)


def video_state_from_numpy(d: dict, device=None) -> VideoState:
    """A JAX VideoState (numpy arrays keyed by field name). The learned
    tracker's network fields (fmaps, nets, inps) are ignored: this slice
    does not carry them."""
    return _fields(VideoState, d, device)
