"""DROID tracking network: fnet / cnet encoders + ConvGRU update operator
(counterpart of splatslam_tpu/models/droid_net.py; reference
thirdparty/glorie_slam/modules/droid_net/{extractor.py, gru.py,
droid_net.py}).

Structure, channel counts and submodule names are those of the released
`droid.pth` checkpoint (`fnet.layer1.0.conv1`, `update.corr_encoder.0`,
`update.gru.convz`, `update.agg.eta.0`, ...), so its state dict loads by
name once the two heads are sliced (models/weights.py). The reference's
GradientClip hooks are no-ops at inference and are left out: the tracker
never backpropagates through the network.

Layout: every module takes and returns channel-first (B, C, H, W), the
layout PyTorch convolutions want; the video's network fields are stored
that way too (tracking/depth_video.py).

Dtype: the parameters of a module are its compute dtype. The hot path
builds the net in `compute_dtype()` (bf16 unless SPLATSLAM_F32_NET is set);
every entry point casts its inputs to the parameters' dtype, so
activations are bf16 there, as in the JAX package. Bundle adjustment and
the correlation volumes stay float32.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def compute_dtype():
    """Network compute dtype on the hot path: bf16, or float32 when
    SPLATSLAM_F32_NET is set (parity debugging). The one place it is read."""
    return torch.float32 if os.environ.get("SPLATSLAM_F32_NET") \
        else torch.bfloat16


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """RGB (..., H, W, 3), uint8 0-255 or float [0,1] → ImageNet-normalised
    float32 (..., 3, H, W)."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    mean = images.new_tensor(IMAGE_MEAN)
    std = images.new_tensor(IMAGE_STD)
    return ((images - mean) / std).movedim(-1, -3)


def _norm(x, norm_fn: str):
    """InstanceNorm2d as the reference uses it: no affine, eps 1e-5, biased
    variance; cnet has none."""
    if norm_fn == "instance":
        return F.instance_norm(x, eps=1e-5)
    if norm_fn == "none":
        return x
    raise ValueError(norm_fn)


class ResidualBlock(nn.Module):
    """3x3-3x3 residual block (reference extractor.py:18-69)."""

    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = None
        if stride > 1:
            # the checkpoint's name for this convolution is `downsample.0`
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride))

    def forward(self, x):
        y = F.relu(_norm(self.conv1(x), self.norm_fn))
        y = F.relu(_norm(self.conv2(y), self.norm_fn))
        if self.downsample is not None:
            x = _norm(self.downsample(x), self.norm_fn)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """3-stage stride-8 residual CNN (reference extractor.py:75-140)."""

    def __init__(self, out_dim, norm_fn="instance"):
        super().__init__()
        self.norm_fn = norm_fn
        D = 32
        self.conv1 = nn.Conv2d(3, D, 7, stride=2, padding=3)
        blk = lambda i, o, s: ResidualBlock(i, o, norm_fn, s)
        self.layer1 = nn.Sequential(blk(D, D, 1), blk(D, D, 1))
        self.layer2 = nn.Sequential(blk(D, 2 * D, 2), blk(2 * D, 2 * D, 1))
        self.layer3 = nn.Sequential(blk(2 * D, 4 * D, 2),
                                    blk(4 * D, 4 * D, 1))
        self.conv2 = nn.Conv2d(4 * D, out_dim, 1)

    def forward(self, x):
        x = F.relu(_norm(self.conv1(x), self.norm_fn))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class ConvGRU(nn.Module):
    """3x3 ConvGRU with global-context gates (reference gru.py:19-47)."""

    def __init__(self, h_planes=128, i_planes=128):
        super().__init__()
        hp = h_planes
        self.w = nn.Conv2d(hp, hp, 1)
        self.convz = nn.Conv2d(hp + i_planes, hp, 3, padding=1)
        self.convr = nn.Conv2d(hp + i_planes, hp, 3, padding=1)
        self.convq = nn.Conv2d(hp + i_planes, hp, 3, padding=1)
        self.convz_glo = nn.Conv2d(hp, hp, 1)
        self.convr_glo = nn.Conv2d(hp, hp, 1)
        self.convq_glo = nn.Conv2d(hp, hp, 1)

    def forward(self, net, inp):
        net_inp = torch.cat([net, inp], 1)
        glo = (torch.sigmoid(self.w(net)) * net).mean((2, 3), keepdim=True)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], 1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    """Per-keyframe aggregation → damping eta + upsample mask (reference
    droid_net.py:48-80)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 128, 3, padding=1)
        self.eta = nn.Sequential(nn.Conv2d(128, 1, 3, padding=1))
        self.upmask = nn.Sequential(nn.Conv2d(128, 8 * 8 * 9, 1))

    def forward(self, net, ix, num_kf: int):
        """net (N,128,h,w); ix (N,) long, the slot of each edge's source
        keyframe in 0..num_kf-1. Returns eta (num_kf,h,w) and upmask
        (num_kf,576,h,w)."""
        net = F.relu(self.conv1(net))
        # scatter-mean over the edges that share a source keyframe, summed
        # and counted in float32
        s = net.new_zeros((num_kf,) + net.shape[1:], dtype=torch.float32)
        s.index_add_(0, ix, net.float())
        cnt = torch.zeros(num_kf, device=net.device).index_add_(
            0, ix, torch.ones(ix.shape[0], device=net.device))
        net = (s / cnt.clamp(min=1.0)[:, None, None, None]).to(net.dtype)
        net = F.relu(self.conv2(net))
        eta = 0.01 * F.softplus(self.eta(net))[:, 0]
        return eta, self.upmask(net)


class UpdateModule(nn.Module):
    """Correlation and flow encoders, ConvGRU, delta/weight heads (reference
    droid_net.py:83-153)."""

    def __init__(self):
        super().__init__()
        cor_planes = 4 * (2 * 3 + 1) ** 2
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(cor_planes, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.flow_encoder = nn.Sequential(
            nn.Conv2d(4, 128, 7, padding=3), nn.ReLU(),
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU())
        self.weight = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1))
        self.delta = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1))
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, ix=None, num_kf: int = 0):
        """net/inp (N,128,h,w); corr (N,196,h,w); flow (N,4,h,w). Returns
        (net, delta, weight) and, when ix is given, also (eta, upmask)."""
        if flow is None:
            flow = net.new_zeros((net.shape[0], 4) + net.shape[2:])
        corr = self.corr_encoder(corr)
        flow = self.flow_encoder(flow)
        net = self.gru(net, torch.cat([inp, corr, flow], 1))
        delta = self.delta(net)
        weight = torch.sigmoid(self.weight(net))
        if ix is not None:
            eta, upmask = self.agg(net, ix, num_kf)
            return net, delta, weight, eta, upmask
        return net, delta, weight


class DroidNet(nn.Module):
    """fnet (instance norm, 128 channels) + cnet (no norm, 256) + update
    (reference droid_net.py:156-162). Inference only: built in eval mode
    with gradients off. `device` None is the GPU (resolve_device)."""

    def __init__(self, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.fnet = BasicEncoder(128, "instance")
        self.cnet = BasicEncoder(256, "none")
        self.update = UpdateModule()
        self.weights_source = "random"
        if generator is not None:
            self.init_random(generator)
        self.to(device=device, dtype=dtype)
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def init_random(self, generator):
        """Seeded initialisation: weights N(0, 1/fan_in), biases zero."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(fan_in))
                m.bias.zero_()

    @property
    def dtype(self):
        return self.fnet.conv1.weight.dtype

    @property
    def device(self):
        return self.fnet.conv1.weight.device

    def _c(self, x):
        return None if x is None else x.to(self.dtype)

    def features(self, images):
        """Normalised images (B,3,H,W) → fmap (B,128,H/8,W/8)."""
        return self.fnet(self._c(images))

    def context(self, images):
        """Normalised images (B,3,H,W) → (tanh net, relu inp), each
        (B,128,H/8,W/8)."""
        net, inp = self.cnet(self._c(images)).chunk(2, dim=1)
        return torch.tanh(net), F.relu(inp)

    def update_step(self, net, inp, corr, flow=None):
        """Per-edge half of the update operator: (net, delta, weight)."""
        return self.update(self._c(net), self._c(inp), self._c(corr),
                           self._c(flow))

    def update_agg(self, net, ix, num_kf: int):
        """GraphAgg half: per-keyframe damping eta + upsample mask."""
        return self.update.agg(self._c(net), ix, num_kf)

    def forward(self, images, net, inp, corr, flow=None, ix=None,
                num_kf: int = 0):
        """All three submodules at once: (fmap, net, inp, update outputs)."""
        cn, ci = self.context(images)
        return self.features(images), cn, ci, self.update(
            self._c(net), self._c(inp), self._c(corr), self._c(flow), ix,
            num_kf)
