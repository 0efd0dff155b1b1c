"""One mapping iteration in plain float32: the render of a camera batch,
the loss, its gradient in the Gaussian parameters, and the Adam step.

Frozen copies of the port's `mapping/mapper._step_shards` (one shard, no
pose optimisation: what the Gaussians' gradient depends on),
`_iso_loss`, `_colors` at SH degree 0 and `mapping/gaussians.adam_step`,
taken when the benchmark was written, over the reference's own
rasterizer (its compositor the plain one) and loss.
"""

from __future__ import annotations

import torch

from . import rasterizer as rz
from .losses import mapping_loss

PARAM_NAMES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
SH_C0 = 0.28209479177387814


def _iso_loss(scal, alive, weight):
    iso = (scal - scal.mean(-1, keepdim=True)).abs()
    iso = torch.where(alive[:, None], iso, torch.zeros_like(iso))
    return weight * iso.sum() / torch.clamp(3 * alive.sum(), min=1)


def step(params, alive, w2cs, images, depths, exposure, use_exposure,
         cam_valid, intrinsics, iso_weight, *, H, W, K, alpha, max_span):
    """(color (B,H,W,3), depth (B,H,W), loss, {name: gradient})."""
    leaves = {n: params[n].detach().clone().requires_grad_(True)
              for n in PARAM_NAMES}
    B = w2cs.shape[0]
    opac = torch.sigmoid(leaves["opacity"])[:, 0]
    scal = torch.exp(leaves["scaling"])
    cols = torch.clamp(leaves["f_dc"] * SH_C0 + 0.5, min=0.0)
    out = rz.rasterize_batch(
        leaves["xyz"], scal, leaves["rotation"], opac, cols, alive, w2cs,
        torch.zeros((B, 6), device=w2cs.device), intrinsics,
        torch.zeros(3, device=w2cs.device), H=H, W=W, K=K,
        want_touched=True, max_span=max_span)
    ue = use_exposure[:, None, None, None]
    image_ab = torch.where(
        ue, torch.exp(exposure[:, 0, None, None, None]) * out.color
        + exposure[:, 1, None, None, None], out.color)
    per_cam = mapping_loss(image_ab, out.depth, images, depths, alpha=alpha)
    total = torch.where(cam_valid, per_cam, torch.zeros_like(per_cam)).sum()
    total = total + _iso_loss(scal, alive, iso_weight)
    names = list(PARAM_NAMES)
    grads = torch.autograd.grad(total, [leaves[n] for n in names],
                                allow_unused=True)
    grads = {n: torch.zeros_like(leaves[n]) if g is None else g
             for n, g in zip(names, grads)}
    return out.color.detach(), out.depth.detach(), total.detach(), grads


def adam(params, m, v, grads, alive, lrs, step_, b1=0.9, b2=0.999,
         eps=1e-15):
    """The parameters after one Adam step from moments m, v."""
    t = float(step_)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    out = {}
    for n in PARAM_NAMES:
        g = torch.where(alive.reshape((-1,) + (1,) * (grads[n].dim() - 1)),
                        grads[n], 0.0)
        mn = m[n] * b1 + (1 - b1) * g
        vn = v[n] * b2 + (1 - b2) * g * g
        out[n] = params[n] - lrs[n] * (mn / bc1) / (torch.sqrt(vn / bc2)
                                                    + eps)
    return out
