"""The tracker's learned stages in plain float32: the admission scan's
flow magnitude and the update operator over an edge set.

Frozen copies of the port's `tracking/motion_filter.flow_magnitude`,
`tracking/factor_graph.update_operator` and `tracking/depth_video.
reproject`, taken when the benchmark was written, over the reference's
own network, correlation and geometry.
"""

from __future__ import annotations

import torch

from . import corr as corr_ops
from . import projective as pops
from .droid_net import normalize_images

# bytes of level-0 correlation volume (N·(h·w)²·4) one alt_corr call holds
CORR_CHUNK_BYTES = 256 << 20


def encode(model, images_u8):
    """uint8 frames (C,H,W,3) → (fmaps, nets, inps), each (C,128,h,w)."""
    x = normalize_images(images_u8)
    net, inp = model.cnet(x).chunk(2, dim=1)
    return model.fnet(x), torch.tanh(net), torch.relu(inp)


def flow_magnitude(model, fmap_last, gmap, net_last, inp_last):
    """One update step against the last keyframe: the mean ‖delta‖."""
    h, w = fmap_last.shape[-2:]
    coords0 = pops.coords_grid(h, w, device=fmap_last.device)[None]
    pyr = corr_ops.build_corr_pyramid(fmap_last[None], gmap[None])
    corr = corr_ops.lookup_pyramid(pyr, coords0)
    _, delta, _ = model.update(net_last[None], inp_last[None], corr)
    return delta.norm(dim=1).mean()


def reproject(poses, disps, intrinsics, ii, jj):
    intr = intrinsics.expand(poses.shape[0], 4)
    coords, valid = pops.projective_transform(
        poses[None], disps[None], intr[None], ii, jj)
    return coords[0], valid[0]


def update_operator(model, poses, disps, intrinsics, fmaps, inps, net,
                    target, ii, jj):
    """One DROID update over an edge set: (net', target', weight, eta,
    upmask, coords1); fmaps/inps are indexed by frame as ii/jj are."""
    h, w = disps.shape[-2:]
    coords1, _ = reproject(poses, disps, intrinsics, ii, jj)
    coords0 = pops.coords_grid(h, w, device=disps.device)
    motn = torch.cat([coords1 - coords0, target - coords1], -1)
    motn = motn.clamp(-64.0, 64.0).permute(0, 3, 1, 2)
    frames = torch.unique(torch.cat([ii, jj]))
    pyr = corr_ops.build_fmap_pyramid(fmaps[frames])
    ii_r, jj_r = torch.searchsorted(frames, ii), torch.searchsorted(frames, jj)
    step = max(1, CORR_CHUNK_BYTES // (4 * (h * w) ** 2))
    corr = torch.cat([
        corr_ops.alt_corr(pyr, ii_r[c:c + step], jj_r[c:c + step],
                          coords1[c:c + step])
        for c in range(0, ii.shape[0], step)])
    net, delta, weight = model.update(net, inps[ii], corr, motn)
    uniq, ix = torch.unique(ii, return_inverse=True)
    eta, upmask = model.update.agg(net, ix, uniq.shape[0])
    target = coords1 + delta.permute(0, 2, 3, 1)
    return net, target, weight.permute(0, 2, 3, 1), eta, upmask, coords1
