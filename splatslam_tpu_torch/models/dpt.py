"""Omnidata DPT-hybrid monocular depth network (counterpart of
splatslam_tpu/models/dpt.py).

Reference: thirdparty/mono_priors/omnidata/modules/midas/{dpt_depth.py,
vit.py, blocks.py} — backbone "vitb_rn50_384": a ResNetV2-50 stem
(weight-standardised convolutions + GroupNorm, timm BiT style) feeding a
ViT-B/16 with project-readout, hooks [stage0, stage1, block8, block11], a
RefineNet fusion decoder and a depth head. Channel-first, float32.

The module tree carries the layout of the omnidata checkpoint
(`omnidata_dpt_depth_v2.ckpt`: `pretrained.*` + `scratch.*`, timm
vit_base_r50_s16_384 names), so loading it is `load_state_dict` after the
lightning 'model.' prefix is stripped. The checkpoint does not ship with
the repository; `DPTDepthPredictor` loads it when present, raises a clear
error when a path is given and missing, and draws seeded weights when the
path is empty.

Prediction protocol (src/mono_estimators.py:49-73): resize to 512², normalise
(0.5, 0.5), forward, clamp to [0, 1], resize back. The two resizes follow
`jax.image.resize` (`resize` below), not `F.interpolate`: the JAX package
is the reference this port is held against.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device


# ---------------------------------------------------------------------------
# separable resize with jax.image.resize's weights
# ---------------------------------------------------------------------------

def _triangle_kernel(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic_kernel(x):
    # Keys cubic convolution, a = -0.5 (x is already |distance|)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"bilinear": _triangle_kernel, "bicubic": _keys_cubic_kernel}


def resize_weights(n_in: int, n_out: int, kernel: str, device=None):
    """(n_in, n_out) float32 matrix that resamples one axis: half-pixel
    centres, the kernel widened by the scale when downsampling
    (antialiasing), every column normalised by the sum of its weights (so
    the border renormalises instead of clamping indices)."""
    fn = _KERNELS[kernel]
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() \
        / kernel_scale
    w = fn(x)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, out_hw, kernel: str = "bilinear"):
    """Resize the last two axes of `x` to `out_hw` as
    `jax.image.resize(..., method=kernel, antialias=True)` does: two weight
    matrices applied as matmuls. An axis whose size does not change is left
    alone."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    if Ho != H:
        x = resize_weights(H, Ho, kernel, x.device).T @ x
    if Wo != W:
        x = x @ resize_weights(W, Wo, kernel, x.device)
    return x


# ---------------------------------------------------------------------------
# ResNetV2 stem (timm BiT): weight-standardised conv + GroupNorm(32)
# ---------------------------------------------------------------------------

def _same_pad(k: int, s: int):
    """TF-'SAME' padding (lo, hi) for even input sizes (timm *Same layers):
    (7, 2) → (2, 3); (3, 2) → (0, 1); stride 1 → symmetric k//2."""
    if s == 1:
        return k // 2, k // 2
    total = max(k - s, 0)
    return total // 2, total - total // 2


class StdConv(nn.Conv2d):
    """timm StdConv2dSame: the weights are standardised per output channel
    at forward time (biased variance, eps 1e-6), so raw checkpoint weights
    load directly; the input is padded TF-'SAME' and the convolution itself
    is unpadded."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=False)
        self.same = _same_pad(k, stride)

    def forward(self, x):
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True,
                                   unbiased=False)
        w = (self.weight - mean) * torch.rsqrt(var + 1e-6)
        lo, hi = self.same
        if lo or hi:
            x = F.pad(x, (lo, hi, lo, hi))
        return F.conv2d(x, w, None, self.stride)


def _gn(c):
    return nn.GroupNorm(32, c, eps=1e-5)


class _ConvNorm(nn.Module):
    """The checkpoint's `stem` and `downsample`: a StdConv and its norm."""

    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv = StdConv(cin, cout, k, stride)
        self.norm = _gn(cout)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """ResNetV2 non-preact bottleneck (timm's vit_base_r50_s16_384 backbone
    is ResNetV2(preact=False)): conv → GroupNorm (+relu) ×3 with a conv+norm
    downsample shortcut and a final relu after the add."""

    def __init__(self, cin, mid, out, stride=1):
        super().__init__()
        self.downsample = (_ConvNorm(cin, out, 1, stride)
                           if stride != 1 or cin != out else None)
        self.conv1 = StdConv(cin, mid, 1)
        self.norm1 = _gn(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = _gn(mid)
        self.conv3 = StdConv(mid, out, 1)
        self.norm3 = _gn(out)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.relu(y + shortcut)


RESNET_DEPTHS = (3, 4, 9)


class _Stage(nn.Module):
    def __init__(self, cin, mid, out, depth, stride):
        super().__init__()
        self.blocks = nn.ModuleList(
            Bottleneck(cin if b == 0 else out, mid, out,
                       stride if b == 0 else 1) for b in range(depth))

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class ResNetV2Stem(nn.Module):
    """Stem + 3 stages of ResNetV2-50 (depths (3, 4, 9), output stride 16).
    Returns the stage-0 (/4, 256 ch) and stage-1 (/8, 512 ch) activations
    and the final /16 feature."""

    def __init__(self):
        super().__init__()
        self.stem = _ConvNorm(3, 64, 7, 2)
        self.stages = nn.ModuleList([
            _Stage(64, 64, 256, RESNET_DEPTHS[0], 1),
            _Stage(256, 128, 512, RESNET_DEPTHS[1], 2),
            _Stage(512, 256, 1024, RESNET_DEPTHS[2], 2)])

    def forward(self, x):
        x = F.relu(self.stem(x))
        # max-pool 'same' k3 s2: one row/column of -inf below and right
        x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2)
        act1 = self.stages[0](x)
        act2 = self.stages[1](act1)
        return act1, act2, self.stages[2](act2)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

class MHA(nn.Module):
    def __init__(self, dim=768, heads=12):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # each (B, heads, N, d)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))          # exact (erf) GELU


class ViTBlock(nn.Module):
    def __init__(self, dim=768, mlp=3072, heads=12):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MHA(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.backbone = ResNetV2Stem()
        self.proj = nn.Conv2d(1024, dim, 1)


class _ViT(nn.Module):
    """The checkpoint's `pretrained.model`: hybrid patch embedding, tokens
    and blocks (its final norm and head are never run on the DPT branch and
    are not kept)."""

    def __init__(self, dim, num_blocks, patch_grid):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, patch_grid ** 2 + 1,
                                                  dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, 4 * dim)
                                    for _ in range(num_blocks))


class _ProjectReadout(nn.Module):
    """Concatenate the broadcast cls token, project, GELU."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.ModuleDict({"0": nn.Linear(2 * dim, dim)})

    def forward(self, tok):
        spatial = tok[:, 1:]
        cat = torch.cat([spatial, tok[:, :1].expand_as(spatial)], -1)
        return F.gelu(self.project["0"](cat))


class _Pretrained(nn.Module):
    def __init__(self, dim, features, num_blocks, patch_grid):
        super().__init__()
        self.model = _ViT(dim, num_blocks, patch_grid)
        # indices as in the checkpoint's nn.Sequential; the entries between
        # them (transpose, unflatten) hold no weights
        self.act_postprocess3 = nn.ModuleDict({
            "0": _ProjectReadout(dim),
            "3": nn.Conv2d(dim, features * 3 // 2, 1)})
        self.act_postprocess4 = nn.ModuleDict({
            "0": _ProjectReadout(dim),
            "3": nn.Conv2d(dim, dim, 1),
            "4": nn.Conv2d(dim, dim, 3, stride=2, padding=1)})


# ---------------------------------------------------------------------------
# DPT decoder
# ---------------------------------------------------------------------------

def _resize2x(x):
    """2× bilinear upsample with align_corners=True (FeatureFusionBlock and
    the head, blocks.py:340-342, dpt_depth.py:98)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """FeatureFusionBlock_custom (blocks.py:296-): optional skip through
    resConfUnit1, then resConfUnit2, 2× bilinear upsample, 1×1 out conv."""

    def __init__(self, features):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(_resize2x(self.resConfUnit2(x)))


class _Scratch(nn.Module):
    def __init__(self, dim, features):
        super().__init__()
        for i, cin in ((1, 256), (2, 512), (3, features * 3 // 2), (4, dim)):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(cin, features, 3, padding=1, bias=False))
            # refinenet4 has no skip input: its resConfUnit1 is in the
            # checkpoint and never run (blocks.py:331-338)
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        # indices as in the checkpoint's nn.Sequential (1 interpolates,
        # 3 and 5 are ReLUs)
        self.output_conv = nn.ModuleDict({
            "0": nn.Conv2d(features, features // 2, 3, padding=1),
            "2": nn.Conv2d(features // 2, 32, 3, padding=1),
            "4": nn.Conv2d(32, 1, 1)})


# parameters the checkpoint holds that no forward pass reads
UNUSED_PREFIX = "scratch.refinenet4.resConfUnit1."


class DPTDepthModel(nn.Module):
    """vitb_rn50_384 DPT depth net: (B, 3, H, W) → (B, H, W), H and W
    multiples of 32. The one width the JAX package has."""

    def __init__(self, features=256, vit_dim=768, num_blocks=12,
                 patch_grid=24):
        super().__init__()
        self.vit_dim = vit_dim
        # the checkpoint-native grid (384/16); resized to the run-time grid
        # like timm's forward_flex
        self.patch_grid = patch_grid
        self.pretrained = _Pretrained(vit_dim, features, num_blocks,
                                      patch_grid)
        self.scratch = _Scratch(vit_dim, features)

    def forward(self, x):
        B, _, H, W = x.shape
        gh, gw = H // 16, W // 16
        vit = self.pretrained.model
        act1, act2, feat = vit.patch_embed.backbone(x)

        tokens = vit.patch_embed.proj(feat).flatten(2).transpose(1, 2)
        pos = vit.pos_embed
        pos_grid = pos[0, 1:].T.reshape(self.vit_dim, self.patch_grid,
                                        self.patch_grid)
        pos_grid = resize(pos_grid, (gh, gw), "bilinear")
        tokens = tokens + pos_grid.flatten(1).T[None]
        tokens = torch.cat(
            [(vit.cls_token + pos[:, :1]).expand(B, -1, -1), tokens], 1)

        # the hooks take the RAW outputs of blocks 8 and 11: the reference's
        # forward hooks fire before model.norm (vit.py:66-75)
        hooks = {}
        for i, blk in enumerate(vit.blocks):
            tokens = blk(tokens)
            if i in (8, 11):
                hooks[i] = tokens

        def grid(tok):                                # (B, N, D) → (B,D,gh,gw)
            return tok.transpose(1, 2).reshape(B, self.vit_dim, gh, gw)

        p3, p4 = self.pretrained.act_postprocess3, \
            self.pretrained.act_postprocess4
        l3 = p3["3"](grid(p3["0"](hooks[8])))
        l4 = p4["4"](p4["3"](grid(p4["0"](hooks[11]))))

        s = self.scratch
        r1, r2 = s.layer1_rn(act1), s.layer2_rn(act2)
        r3, r4 = s.layer3_rn(l3), s.layer4_rn(l4)
        path = s.refinenet4(r4)
        path = s.refinenet3(path, r3)
        path = s.refinenet2(path, r2)
        path = s.refinenet1(path, r1)

        h = _resize2x(s.output_conv["0"](path))
        h = F.relu(s.output_conv["2"](h))
        h = F.relu(s.output_conv["4"](h))
        return h[:, 0]


def init_seeded(model: DPTDepthModel, seed: int = 0):
    """Seeded weights for a run without a checkpoint, drawn on the host so
    they are the same on every device: LeCun-normal kernels, zero biases,
    unit norms, a 0.02-normal positional embedding and a zero cls token (the
    distributions the JAX package initialises with). The head's last 1×1
    convolution is then made non-negative and scaled by 1/16: with signed
    weights its ReLU shuts on all but ~0.5% of the pixels and the "prior"
    is a field of zeros; so it spreads over (0, 1) on the Synthetic scene
    and the code that consumes a prior sees values."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("pos_embed"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name.endswith("cls_token") or name.endswith(".bias"):
                p.zero_()
            elif p.dim() == 1:                        # norm scales
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen)
                        / math.sqrt(fan_in))
        model.scratch.output_conv["4"].weight.abs_().div_(16.0)
    return model


def load_omnidata_state_dict(model: DPTDepthModel, sd: dict):
    """Load a mapping of the checkpoint's names (after the 'model.' strip)
    to tensors or arrays into `model`. Every parameter a forward pass reads
    must be present with its shape; what the checkpoint holds beyond the
    module tree (the ViT's final norm and head) is ignored."""
    own = model.state_dict()
    new = {}
    for k, ref in own.items():
        if k not in sd:
            if k.startswith(UNUSED_PREFIX):
                continue
            raise KeyError(f"omnidata checkpoint lacks {k!r}")
        v = sd[k]
        v = (v.detach().cpu() if hasattr(v, "detach")
             else torch.from_numpy(np.array(v))).to(torch.float32)
        if v.shape != ref.shape:
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)}, "
                             f"module shape {tuple(ref.shape)}")
        new[k] = v
    model.load_state_dict(new, strict=False)
    return model


def load_omnidata_params(path: str, model: DPTDepthModel | None = None):
    """Load the omnidata checkpoint (`omnidata_dpt_depth_v2.ckpt`, a
    lightning file or a bare state dict) into a DPTDepthModel."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    # strip the lightning 'model.' prefix (mono_estimators.py:38-40)
    if any(k.startswith("model.") for k in sd):
        sd = {k[6:]: v for k, v in sd.items() if k.startswith("model.")}
    return load_omnidata_state_dict(model or DPTDepthModel(), sd)


class DPTDepthPredictor:
    """Prediction wrapper (mono_estimators.py:49-73 protocol). `device`
    None is the GPU (resolve_device); float32 with TF32 off."""

    def __init__(self, ckpt_path: str | None = None, size: int = 512,
                 device=None):
        self.size = size
        self.calls = 0          # predictions made, for a caller's accounting
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = DPTDepthModel()
        if ckpt_path:
            if not os.path.exists(ckpt_path):
                raise FileNotFoundError(
                    f"omnidata checkpoint not found: {ckpt_path} — "
                    "download omnidata_dpt_depth_v2.ckpt or use "
                    "mono_prior.provider: files/oracle")
            load_omnidata_params(ckpt_path, self.model)
        else:
            init_seeded(self.model, seed=0)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def network_output(self, image) -> torch.Tensor:
        """The network's (size, size) output before the clamp, for an
        (H, W, 3) image in [0, 1]."""
        x = torch.as_tensor(np.asarray(image), dtype=torch.float32,
                            device=self.device).permute(2, 0, 1)
        x = resize(x, (self.size, self.size), "bilinear")
        return self.model(((x - 0.5) / 0.5)[None])[0]

    @torch.no_grad()
    def __call__(self, image) -> np.ndarray:
        self.calls += 1
        H, W = np.shape(image)[:2]
        d = torch.clamp(self.network_output(image), 0.0, 1.0)
        return resize(d, (H, W), "bicubic").cpu().numpy()
