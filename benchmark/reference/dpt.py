"""The omnidata DPT-Hybrid depth network (backbone vitb_rn50_384) as plain
torch functions over a state dict of the omnidata checkpoint's names (after
the lightning 'model.' strip): `forward(sd, x)` maps (B, 3, H, W), H and W
multiples of 32, to the (B, H, W) depth output, in the dtype of `sd`'s
tensors. The widths are read from the tensors' shapes.

Written from the published description (Ranftl, Bochkovskiy, Koltun,
"Vision Transformers for Dense Prediction", ICCV 2021; omnidata's
modules/midas/{dpt_depth,vit,blocks}.py over timm's vit_base_r50_s16_384):

  * stem: ResNetV2-50 without pre-activation, stages of depth 3, 4 and 9,
    weight-standardised convolutions (StdConv2dSame: the weight less its
    mean over each output channel, over its biased standard deviation,
    input padded TF-"SAME"), GroupNorm(32, eps 1e-5), a 3x3 stride-2
    max-pool padded "SAME" with -inf, the stride on each stage's first 3x3
    convolution;
  * tokens: a 1x1 projection of the /16 feature to 768, the cls token, the
    positional embedding of the 24x24 grid resized to the input's grid;
  * transformer: ViT-B/16 blocks (pre-norm LayerNorm eps 1e-6, 12 heads of
    64 with scale 64**-0.5, MLP 3072 with the erf GELU);
  * hooks: the stem's stage 0 and stage 1 outputs, and the raw outputs of
    blocks 8 and 11 (before the ViT's final norm);
  * readout "project": each token concatenated with the cls token, a
    linear map back to 768 and a GELU; reassembly by 1x1 convolutions (and
    a 3x3 stride-2 one at block 11);
  * RefineNet decoder at 256 features: a 3x3 convolution per hook, four
    fusion blocks (residual units pre-activated by ReLU, 2x bilinear
    upsampling with aligned corners, a 1x1 convolution), and the head
    (3x3 to 128, 2x upsampling, 3x3 to 32, ReLU, 1x1 to 1, ReLU).

Departures from the published code:

  * the positional grid is resized by the antialiased triangle filter of
    `jax.image.resize` (half-pixel centres, the filter widened by the
    scale when shrinking, each output's weights normalised), as the
    program does; timm's `_resize_pos_embed` calls F.interpolate's
    bilinear, which is the same filter when the grid grows (every input
    of 384 pixels or more a side, 512x512 among them) and takes no
    antialiasing when it shrinks (the tests' small inputs);
  * the weight standardisation's eps is 1e-6, timm's StdConv2dSame
    default, as the program has it (timm's later hybrid constructor passes
    1e-8);
  * `forward` reads the widths from the tensors' shapes; `departures`
    holds a state dict and an input to the published network (every
    tensor's name and shape, from the constants below, and the 512x512
    input) and names what differs;
  * norms, GELU and attention are written out from their definitions, not
    taken from torch.nn.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the published network: ResNetV2-50 stem (stage depths, bottleneck and
# output widths), ViT-B/16 on a 24x24 grid, the hooks reassembled at
# (256, 512, 768, 768), a RefineNet decoder at 256 features, the head, and
# the 512x512 input that Splat-SLAM resizes each frame to
STAGE_DEPTHS = (3, 4, 9)
STAGE_MID = (64, 128, 256)
STAGE_OUT = (256, 512, 1024)
STEM = 64
DIM, HEADS, MLP, BLOCKS, GRID = 768, 12, 3072, 12, 24
REASSEMBLE = (256, 512, 768, 768)
FEATURES = 256
HEAD = (128, 32, 1)
INPUT = (1, 3, 512, 512)
BACKBONE = "pretrained.model.patch_embed.backbone"
# refinenet4 has no skip input: the checkpoint holds a unit no pass reads
UNUSED = "scratch.refinenet4.resConfUnit1."


def published_shapes():
    """{name: shape} of every tensor the published network's pass reads."""
    out = {}

    def conv(p, cout, cin, k, bias=True):
        out[p + ".weight"] = (cout, cin, k, k)
        if bias:
            out[p + ".bias"] = (cout,)

    def vec(p, n):
        out[p + ".weight"] = out[p + ".bias"] = (n,)

    def dense(p, cout, cin):
        out[p + ".weight"], out[p + ".bias"] = (cout, cin), (cout,)

    conv(BACKBONE + ".stem.conv", STEM, 3, 7, bias=False)
    vec(BACKBONE + ".stem.norm", STEM)
    cin = STEM
    for s, (depth, mid, cout) in enumerate(zip(STAGE_DEPTHS, STAGE_MID,
                                               STAGE_OUT)):
        for b in range(depth):
            p = f"{BACKBONE}.stages.{s}.blocks.{b}"
            if b == 0:
                conv(p + ".downsample.conv", cout, cin, 1, bias=False)
                vec(p + ".downsample.norm", cout)
            for i, (co, ci, k) in enumerate(
                    ((mid, cin, 1), (mid, mid, 3), (cout, mid, 1)), 1):
                conv(f"{p}.conv{i}", co, ci, k, bias=False)
                vec(f"{p}.norm{i}", co)
            cin = cout
    m = "pretrained.model"
    conv(m + ".patch_embed.proj", DIM, cin, 1)
    out[m + ".cls_token"] = (1, 1, DIM)
    out[m + ".pos_embed"] = (1, 1 + GRID * GRID, DIM)
    for i in range(BLOCKS):
        p = f"{m}.blocks.{i}"
        vec(p + ".norm1", DIM)
        dense(p + ".attn.qkv", 3 * DIM, DIM)
        dense(p + ".attn.proj", DIM, DIM)
        vec(p + ".norm2", DIM)
        dense(p + ".mlp.fc1", MLP, DIM)
        dense(p + ".mlp.fc2", DIM, MLP)
    for i in (3, 4):
        p = f"pretrained.act_postprocess{i}"
        dense(p + ".0.project.0", DIM, 2 * DIM)
        conv(p + ".3", REASSEMBLE[i - 1], DIM, 1)
    conv("pretrained.act_postprocess4.4", REASSEMBLE[3], REASSEMBLE[3], 3)
    for i, cin in enumerate(REASSEMBLE, 1):
        conv(f"scratch.layer{i}_rn", FEATURES, cin, 3, bias=False)
        p = f"scratch.refinenet{i}"
        for u in (1, 2) if i < 4 else (2,):
            conv(f"{p}.resConfUnit{u}.conv1", FEATURES, FEATURES, 3)
            conv(f"{p}.resConfUnit{u}.conv2", FEATURES, FEATURES, 3)
        conv(p + ".out_conv", FEATURES, FEATURES, 1)
    cin = FEATURES
    for j, (cout, k) in enumerate(zip(HEAD, (3, 3, 1))):
        conv(f"scratch.output_conv.{2 * j}", cout, cin, k)
        cin = cout
    return out


def departures(sd, x_shape):
    """What a state dict and an input shape hold that the published
    network does not: missing, extra and misshaped tensors, and an input
    other than INPUT. Empty for the published network."""
    want = published_shapes()
    have = {k: tuple(v.shape) for k, v in sd.items()
            if not k.startswith(UNUSED)}
    out = [f"missing {k}" for k in want if k not in have]
    out += [f"extra {k}" for k in have if k not in want]
    out += [f"{k} {have[k]}, published {want[k]}" for k in want
            if k in have and have[k] != want[k]]
    if tuple(x_shape) != INPUT:
        out.append(f"input {tuple(x_shape)}, published {INPUT}")
    return out


def _same(x, k, s, value=0.0):
    """TF-"SAME" padding of the last two axes for a k-wide window of
    stride s."""
    def pads(n):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2
    (top, bottom), (left, right) = pads(x.shape[-2]), pads(x.shape[-1])
    return F.pad(x, (left, right, top, bottom), value=value)


def std_conv(x, w, stride=1):
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    w = (w - mean) / torch.sqrt(var + 1e-6)
    return F.conv2d(_same(x, w.shape[-1], stride), w, None, stride)


def group_norm(x, weight, bias, groups=32, eps=1e-5):
    B, C, H, W = x.shape
    g = x.reshape(B, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    g = (g - mean) / torch.sqrt(var + eps)
    return g.reshape(B, C, H, W) * weight[:, None, None] + bias[:, None, None]


def layer_norm(x, weight, bias, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def linear(sd, p, x):
    return x @ sd[p + ".weight"].T + sd[p + ".bias"]


def conv(sd, p, x, stride=1, padding=0):
    return F.conv2d(x, sd[p + ".weight"], sd.get(p + ".bias"), stride,
                    padding)


def _conv_norm(sd, p, x, conv_name, norm_name, stride=1):
    x = std_conv(x, sd[f"{p}.{conv_name}.weight"], stride)
    return group_norm(x, sd[f"{p}.{norm_name}.weight"],
                      sd[f"{p}.{norm_name}.bias"])


def bottleneck(sd, p, x, stride):
    if p + ".downsample.conv.weight" in sd:
        shortcut = _conv_norm(sd, p + ".downsample", x, "conv", "norm",
                              stride)
    else:
        shortcut = x
    y = F.relu(_conv_norm(sd, p, x, "conv1", "norm1"))
    y = F.relu(_conv_norm(sd, p, y, "conv2", "norm2", stride))
    y = _conv_norm(sd, p, y, "conv3", "norm3")
    return F.relu(y + shortcut)


def stem(sd, x):
    """(stage 0 at /4, stage 1 at /8, the /16 feature)."""
    x = F.relu(_conv_norm(sd, BACKBONE + ".stem", x, "conv", "norm", 2))
    x = F.max_pool2d(_same(x, 3, 2, float("-inf")), 3, 2)
    outs = []
    for s, depth in enumerate(STAGE_DEPTHS):
        for b in range(depth):
            x = bottleneck(sd, f"{BACKBONE}.stages.{s}.blocks.{b}", x,
                           2 if (b == 0 and s > 0) else 1)
        outs.append(x)
    return tuple(outs)


def resize_matrix(n_in, n_out, dtype, device):
    """(n_out, n_in): the antialiased triangle filter of one axis."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centre = (torch.arange(n_out, dtype=dtype, device=device) + 0.5) \
        * scale - 0.5
    src = torch.arange(n_in, dtype=dtype, device=device)
    w = torch.clamp(1.0 - (centre[:, None] - src[None, :]).abs() / width,
                    min=0.0)
    return w / w.sum(1, keepdim=True)


def positions(sd, gh, gw):
    """(1 + gh·gw, D): the cls position, then the grid's resized."""
    pos = sd["pretrained.model.pos_embed"][0]
    n = int(round(math.sqrt(pos.shape[0] - 1)))
    grid = pos[1:].T.reshape(-1, n, n)                    # (D, n, n)
    grid = resize_matrix(n, gh, pos.dtype, pos.device) @ grid
    grid = grid @ resize_matrix(n, gw, pos.dtype, pos.device).T
    return torch.cat([pos[:1], grid.flatten(1).T], 0)


def attention(sd, p, x):
    B, N, D = x.shape
    d = D // HEADS
    qkv = linear(sd, p + ".qkv", x).reshape(B, N, 3, HEADS, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # each (B, h, N, d)
    a = torch.softmax((q @ k.transpose(-2, -1)) * d ** -0.5, dim=-1)
    out = (a @ v).transpose(1, 2).reshape(B, N, D)
    return linear(sd, p + ".proj", out)


def vit_block(sd, p, x):
    x = x + attention(sd, p + ".attn", layer_norm(
        x, sd[p + ".norm1.weight"], sd[p + ".norm1.bias"]))
    h = layer_norm(x, sd[p + ".norm2.weight"], sd[p + ".norm2.bias"])
    return x + linear(sd, p + ".mlp.fc2",
                      gelu(linear(sd, p + ".mlp.fc1", h)))


def readout(sd, p, tokens, gh, gw):
    """Project readout, then the tokens as a (B, D, gh, gw) map."""
    spatial = tokens[:, 1:]
    cat = torch.cat([spatial, tokens[:, :1].expand_as(spatial)], -1)
    out = gelu(linear(sd, p + ".0.project.0", cat))
    B, _, D = out.shape
    return out.transpose(1, 2).reshape(B, D, gh, gw)


def residual_unit(sd, p, x):
    y = conv(sd, p + ".conv1", F.relu(x), padding=1)
    return x + conv(sd, p + ".conv2", F.relu(y), padding=1)


def upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def fusion(sd, p, x, skip=None):
    if skip is not None:
        x = x + residual_unit(sd, p + ".resConfUnit1", skip)
    x = upsample2(residual_unit(sd, p + ".resConfUnit2", x))
    return conv(sd, p + ".out_conv", x)


def forward(sd, x):
    B, _, H, W = x.shape
    gh, gw = H // 16, W // 16
    act1, act2, feat = stem(sd, x)
    tokens = conv(sd, "pretrained.model.patch_embed.proj", feat)
    tokens = tokens.flatten(2).transpose(1, 2)
    cls = sd["pretrained.model.cls_token"].expand(B, -1, -1)
    tokens = torch.cat([cls, tokens], 1) + positions(sd, gh, gw)[None]
    hooks = {}
    n_blocks = sum(k.endswith(".attn.qkv.weight") for k in sd)
    for i in range(n_blocks):
        tokens = vit_block(sd, f"pretrained.model.blocks.{i}", tokens)
        if i in (8, 11):
            hooks[i] = tokens
    p3, p4 = "pretrained.act_postprocess3", "pretrained.act_postprocess4"
    l3 = conv(sd, p3 + ".3", readout(sd, p3, hooks[8], gh, gw))
    l4 = conv(sd, p4 + ".3", readout(sd, p4, hooks[11], gh, gw))
    l4 = conv(sd, p4 + ".4", l4, stride=2, padding=1)
    r = [conv(sd, f"scratch.layer{i}_rn", a, padding=1)
         for i, a in enumerate((act1, act2, l3, l4), 1)]
    path = fusion(sd, "scratch.refinenet4", r[3])
    for i in (3, 2, 1):
        path = fusion(sd, f"scratch.refinenet{i}", path, r[i - 1])
    h = upsample2(conv(sd, "scratch.output_conv.0", path, padding=1))
    h = F.relu(conv(sd, "scratch.output_conv.2", h, padding=1))
    return F.relu(conv(sd, "scratch.output_conv.4", h))[:, 0]
