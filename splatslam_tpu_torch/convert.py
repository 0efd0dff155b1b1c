"""State carried across from the JAX package: its GaussianState and
VideoState as dicts of numpy arrays (same field names) into the port's
states, and its DroidNet and DPT parameter trees into the port's networks, so a
run or a test can continue from a JAX map, video, tracker and prior."""

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


def droid_params_to_numpy(model) -> dict:
    """The inverse of droid_params_from_numpy: the port's DroidNet → the
    flax parameter tree of the JAX package's init_params (nested dicts of
    float32 numpy arrays, kernels HWIO), the tree its checkpoints hold."""
    from .models.weights import state_dict_to_flax_tree
    return state_dict_to_flax_tree(model.state_dict())


def dpt_params_from_numpy(tree: dict, device=None):
    """A flax DPTDepthModel parameter tree (nested dicts of numpy arrays,
    HWIO conv kernels, (in, out) dense kernels) → the port's DPTDepthModel
    with those weights, in eval mode on `device` (None is the GPU). The
    tree has no `refinenet4.res1` (never run); the module keeps its own."""
    from .models.dpt import (DPTDepthModel, RESNET_DEPTHS,
                             load_omnidata_state_dict)
    device = resolve_device(device)
    sd = {}

    def conv(dst, src):
        sd[dst + ".weight"] = np.asarray(src["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in src:
            sd[dst + ".bias"] = np.asarray(src["bias"])

    def norm(dst, src):
        sd[dst + ".weight"] = np.asarray(src["scale"])
        sd[dst + ".bias"] = np.asarray(src["bias"])

    def dense(dst, src):
        sd[dst + ".weight"] = np.asarray(src["kernel"]).T
        sd[dst + ".bias"] = np.asarray(src["bias"])

    BB = "pretrained.model.patch_embed.backbone"
    bb = tree["backbone"]
    conv(f"{BB}.stem.conv", bb["stem_conv"])
    norm(f"{BB}.stem.norm", bb["stem_norm"])
    for s, depth in enumerate(RESNET_DEPTHS):
        for b in range(depth):
            blk, p = bb[f"s{s}_b{b}"], f"{BB}.stages.{s}.blocks.{b}"
            for i in (1, 2, 3):
                conv(f"{p}.conv{i}", blk[f"conv{i}"])
                norm(f"{p}.norm{i}", blk[f"norm{i}"])
            if "downsample_conv" in blk:
                conv(p + ".downsample.conv", blk["downsample_conv"])
                norm(p + ".downsample.norm", blk["downsample_norm"])
    conv("pretrained.model.patch_embed.proj", tree["patch_proj"])
    sd["pretrained.model.cls_token"] = np.asarray(tree["cls_token"])
    sd["pretrained.model.pos_embed"] = np.asarray(tree["pos_embed"])
    dense("pretrained.act_postprocess3.0.project.0", tree["readout3_proj"])
    conv("pretrained.act_postprocess3.3", tree["post3"])
    dense("pretrained.act_postprocess4.0.project.0", tree["readout4_proj"])
    conv("pretrained.act_postprocess4.3", tree["post4a"])
    conv("pretrained.act_postprocess4.4", tree["post4b"])
    for i in (0, 2, 4):
        conv(f"scratch.output_conv.{i}", tree[f"head{i}"])
    n_blocks = sum(1 for k in tree if k.startswith("block"))
    for i in range(n_blocks):
        blk, p = tree[f"block{i}"], f"pretrained.model.blocks.{i}"
        norm(p + ".norm1", blk["norm1"])
        dense(p + ".attn.qkv", blk["attn"]["qkv"])
        dense(p + ".attn.proj", blk["attn"]["proj"])
        norm(p + ".norm2", blk["norm2"])
        dense(p + ".mlp.fc1", blk["fc1"])
        dense(p + ".mlp.fc2", blk["fc2"])
    for i in (1, 2, 3, 4):
        conv(f"scratch.layer{i}_rn", tree[f"layer{i}_rn"])
        rf, rp = tree[f"refinenet{i}"], f"scratch.refinenet{i}"
        for unit, name in (("res1", "resConfUnit1"), ("res2", "resConfUnit2")):
            if unit in rf:
                conv(f"{rp}.{name}.conv1", rf[unit]["conv1"])
                conv(f"{rp}.{name}.conv2", rf[unit]["conv2"])
        conv(rp + ".out_conv", rf["out_conv"])
    model = load_omnidata_state_dict(DPTDepthModel(num_blocks=n_blocks), sd)
    return model.to(device).eval()
