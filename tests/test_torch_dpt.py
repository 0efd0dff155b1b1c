"""DPT-hybrid parity: the PyTorch port's network against the JAX package's on
the same numpy inputs and weights, both in float32 on the CPU.

  1. `resize` against `jax.image.resize` (bilinear and bicubic, up and down,
     non-square), atol = rtol = 2e-4;
  2. every block against its Flax block on shared seeded weights at the sizes
     of tests/test_dpt_golden.py, atol = rtol = 2e-4;
  3. the whole network and the predictor at 128² on a full synthetic omnidata
     state dict: the Flax side through `convert_state_dict`, the port through
     its own loader from a lightning-style file, and once more through
     `convert.dpt_params_from_numpy`. Tolerance: 1e-3 of the reference
     output's maximum (twelve float32 transformer blocks and a 30-layer
     convolutional stem with different summation orders).

The JAX side is channel-last (B,H,W,C), the port channel-first (B,C,H,W).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.models import dpt as jdpt
from splatslam_tpu_torch import convert
from splatslam_tpu_torch.models import dpt as tdpt
from test_torch_threads import few_torch_threads  # noqa: F401

TOL = dict(atol=2e-4, rtol=2e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _rnd(rng, *shape, scale=0.2):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    """channel-last numpy → channel-first tensor."""
    return torch.as_tensor(np.moveaxis(x, -1, 1).copy())


def _n(x):
    """channel-first tensor → channel-last numpy."""
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# 1. resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [
    ((24, 24), (8, 8)),        # the positional grid at a 128² input
    ((24, 24), (32, 32)),      # ... at 512²
    ((24, 24), (26, 26)),      # ... at 416²
    ((30, 45), (64, 64)),      # a frame up to the network's square
    ((85, 150), (64, 64)),     # a frame down to it (antialiased)
    ((64, 64), (30, 45)),      # the prediction back down
    ((64, 64), (85, 150)),     # ... and back up
    ((17, 40), (40, 17)),      # one axis up, the other down
    ((20, 33), (20, 50)),      # one axis untouched
])
def test_resize_matches_jax_image_resize(src, dst, kernel):
    x = _rnd(_rng(3), 3, *src, scale=1.0)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, *dst), kernel))
    got = tdpt.resize(torch.as_tensor(x), dst, kernel).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_resize_is_not_torch_interpolate():
    """The reason `resize` exists: PyTorch's bicubic (a = -0.75, clamped
    border) and its non-antialiased downsample differ from JAX's by far more
    than the parity tolerance."""
    x = torch.as_tensor(_rnd(_rng(4), 1, 1, 32, 32, scale=1.0))
    ours = tdpt.resize(x, (48, 48), "bicubic")
    theirs = torch.nn.functional.interpolate(x, (48, 48), mode="bicubic",
                                             align_corners=False)
    assert (ours - theirs).abs().max() > 1e-2
    down = tdpt.resize(x, (8, 8), "bilinear")
    theirs = torch.nn.functional.interpolate(x, (8, 8), mode="bilinear",
                                             align_corners=False)
    assert (down - theirs).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# 2. blocks
# ---------------------------------------------------------------------------

def _conv(w, b=None):
    """torch OIHW weight (+ bias) → flax {"kernel": HWIO, "bias"}."""
    out = {"kernel": w.transpose(2, 3, 1, 0)}
    if b is not None:
        out["bias"] = b
    return out


def _load(module, sd):
    module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _block_case(name):
    """(JAX output, port output), channel-last numpy, for one block."""
    rng = _rng(11)
    r = lambda *s, **kw: _rnd(rng, *s, **kw)
    if name == "stem_conv":
        w = r(16, 3, 7, 7)
        x = r(1, 16, 16, 3, scale=1.0)
        want = jdpt.WSConv(16, (7, 7), strides=2,
                           padding=jdpt._same_pad(7, 2), use_bias=False).apply(
            {"params": _jtree(_conv(w))}, jnp.asarray(x))
        got = _load(tdpt.StdConv(3, 16, 7, 2), {"weight": w})(_t(x))
        return np.asarray(want), _n(got)
    if name.startswith("bottleneck"):
        cin, mid, out, s = ((64, 32, 64, 2) if name == "bottleneck_stride2"
                            else (64, 32, 128, 1) if name == "bottleneck_widen"
                            else (64, 32, 64, 1))
        down = s != 1 or cin != out
        sd = {}
        for i, (co, ci, k) in enumerate(
                [(mid, cin, 1), (mid, mid, 3), (out, mid, 1)], 1):
            sd[f"conv{i}.weight"] = r(co, ci, k, k)
            sd[f"norm{i}.weight"] = r(co) + 1
            sd[f"norm{i}.bias"] = r(co)
        if down:
            sd["downsample.conv.weight"] = r(out, cin, 1, 1)
            sd["downsample.norm.weight"] = r(out) + 1
            sd["downsample.norm.bias"] = r(out)
        x = r(2, 8, 8, cin, scale=1.0)
        norm = lambda k: {"scale": sd[k + ".weight"], "bias": sd[k + ".bias"]}
        fl = {f"conv{i}": _conv(sd[f"conv{i}.weight"]) for i in (1, 2, 3)}
        fl.update({f"norm{i}": norm(f"norm{i}") for i in (1, 2, 3)})
        if down:
            fl["downsample_conv"] = _conv(sd["downsample.conv.weight"])
            fl["downsample_norm"] = norm("downsample.norm")
        want = jdpt.Bottleneck(mid, out, stride=s).apply(
            {"params": _jtree(fl)}, jnp.asarray(x))
        got = _load(tdpt.Bottleneck(cin, mid, out, s), sd)(_t(x))
        return np.asarray(want), _n(got)
    if name == "vit_block":
        Dm, heads, N = 64, 4, 10
        sd = {"norm1.weight": r(Dm) + 1, "norm1.bias": r(Dm),
              "attn.qkv.weight": r(3 * Dm, Dm), "attn.qkv.bias": r(3 * Dm),
              "attn.proj.weight": r(Dm, Dm), "attn.proj.bias": r(Dm),
              "norm2.weight": r(Dm) + 1, "norm2.bias": r(Dm),
              "mlp.fc1.weight": r(2 * Dm, Dm), "mlp.fc1.bias": r(2 * Dm),
              "mlp.fc2.weight": r(Dm, 2 * Dm), "mlp.fc2.bias": r(Dm)}
        x = r(2, N, Dm, scale=1.0)
        dense = lambda k: {"kernel": sd[k + ".weight"].T,
                           "bias": sd[k + ".bias"]}
        norm = lambda k: {"scale": sd[k + ".weight"], "bias": sd[k + ".bias"]}
        fl = {"norm1": norm("norm1"), "norm2": norm("norm2"),
              "attn": {"qkv": dense("attn.qkv"), "proj": dense("attn.proj")},
              "fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2")}
        want = jdpt.ViTBlock(dim=Dm, mlp=2 * Dm, heads=heads).apply(
            {"params": _jtree(fl)}, jnp.asarray(x))
        got = _load(tdpt.ViTBlock(Dm, 2 * Dm, heads), sd)(torch.as_tensor(x))
        return np.asarray(want), got.detach().numpy()
    if name in ("fusion_block", "fusion_block_no_skip"):
        C = 32
        sd = {}
        for u in ("resConfUnit1", "resConfUnit2"):
            for c in ("conv1", "conv2"):
                sd[f"{u}.{c}.weight"] = r(C, C, 3, 3)
                sd[f"{u}.{c}.bias"] = r(C)
        sd["out_conv.weight"] = r(C, C, 1, 1)
        sd["out_conv.bias"] = r(C)
        x = r(1, 6, 6, C, scale=1.0)
        skip = r(1, 6, 6, C, scale=1.0) if name == "fusion_block" else None
        cv = lambda k: _conv(sd[k + ".weight"], sd[k + ".bias"])
        fl = {"res2": {"conv1": cv("resConfUnit2.conv1"),
                       "conv2": cv("resConfUnit2.conv2")},
              "out_conv": cv("out_conv")}
        if skip is not None:
            fl["res1"] = {"conv1": cv("resConfUnit1.conv1"),
                          "conv2": cv("resConfUnit1.conv2")}
        want = jdpt.FeatureFusionBlock(C).apply(
            {"params": _jtree(fl)}, jnp.asarray(x),
            None if skip is None else jnp.asarray(skip))
        got = _load(tdpt.FeatureFusionBlock(C), sd)(
            _t(x), None if skip is None else _t(skip))
        return np.asarray(want), _n(got)
    if name == "resize2x":
        x = r(1, 5, 7, 3, scale=1.0)
        return (np.asarray(jdpt._resize2x(jnp.asarray(x))),
                _n(tdpt._resize2x(_t(x))))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "stem_conv", "bottleneck", "bottleneck_stride2", "bottleneck_widen",
    "vit_block", "fusion_block", "fusion_block_no_skip", "resize2x"])
def test_block_matches_flax(name):
    want, got = _block_case(name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# 3. the whole network on a full synthetic omnidata checkpoint
# ---------------------------------------------------------------------------

SIZE = 128


def synthetic_omnidata_sd(seed=11):
    """Every key of the omnidata vitb_rn50_384 checkpoint that either package
    reads (names after the 'model.' strip), with seeded values of the right
    shape, plus the ViT's final norm and head, which the real file holds and
    nobody runs. Names and shapes are written out here, not taken from either
    package."""
    rng = _rng(seed)
    r = lambda *s, **kw: _rnd(rng, *s, **kw)
    sd = {}

    def norm(k, c):
        sd[k + ".weight"] = r(c) + 1
        sd[k + ".bias"] = r(c)

    # kernels at 1/sqrt(fan_in), so that activations stay O(1) through the
    # depth of the network and the comparison is not one of overflowing sums
    def lin(k, cout, cin):
        sd[k + ".weight"] = r(cout, cin, scale=cin ** -0.5)
        sd[k + ".bias"] = r(cout)

    def conv(k, cout, cin, ks, bias=True):
        sd[k + ".weight"] = r(cout, cin, ks, ks, scale=(cin * ks * ks) ** -0.5)
        if bias:
            sd[k + ".bias"] = r(cout)

    BB = "pretrained.model.patch_embed.backbone"
    conv(f"{BB}.stem.conv", 64, 3, 7, bias=False)
    norm(f"{BB}.stem.norm", 64)
    for s, (depth, cin, mid, out) in enumerate(
            [(3, 64, 64, 256), (4, 256, 128, 512), (9, 512, 256, 1024)]):
        for b in range(depth):
            p = f"{BB}.stages.{s}.blocks.{b}"
            ci = cin if b == 0 else out
            conv(p + ".conv1", mid, ci, 1, bias=False)
            norm(p + ".norm1", mid)
            conv(p + ".conv2", mid, mid, 3, bias=False)
            norm(p + ".norm2", mid)
            conv(p + ".conv3", out, mid, 1, bias=False)
            norm(p + ".norm3", out)
            if b == 0:
                conv(p + ".downsample.conv", out, ci, 1, bias=False)
                norm(p + ".downsample.norm", out)
    V = 768
    conv("pretrained.model.patch_embed.proj", V, 1024, 1)
    sd["pretrained.model.cls_token"] = r(1, 1, V)
    sd["pretrained.model.pos_embed"] = r(1, 24 * 24 + 1, V)
    for i in range(12):
        p = f"pretrained.model.blocks.{i}"
        norm(p + ".norm1", V)
        lin(p + ".attn.qkv", 3 * V, V)
        lin(p + ".attn.proj", V, V)
        norm(p + ".norm2", V)
        lin(p + ".mlp.fc1", 4 * V, V)
        lin(p + ".mlp.fc2", V, 4 * V)
    norm("pretrained.model.norm", V)            # in the file, never run
    lin("pretrained.model.head", 1000, V)       # in the file, never run
    lin("pretrained.act_postprocess3.0.project.0", V, 2 * V)
    conv("pretrained.act_postprocess3.3", 384, V, 1)
    lin("pretrained.act_postprocess4.0.project.0", V, 2 * V)
    conv("pretrained.act_postprocess4.3", V, V, 1)
    conv("pretrained.act_postprocess4.4", V, V, 3)
    for i, cin in ((1, 256), (2, 512), (3, 384), (4, 768)):
        conv(f"scratch.layer{i}_rn", 256, cin, 3, bias=False)
        for u in ("resConfUnit1", "resConfUnit2"):
            conv(f"scratch.refinenet{i}.{u}.conv1", 256, 256, 3)
            conv(f"scratch.refinenet{i}.{u}.conv2", 256, 256, 3)
        conv(f"scratch.refinenet{i}.out_conv", 256, 256, 1)
    conv("scratch.output_conv.0", 128, 256, 3)
    conv("scratch.output_conv.2", 32, 128, 3)
    conv("scratch.output_conv.4", 1, 32, 1)
    # keep the head's last ReLU open and most of the output inside the
    # predictor's clamp to [0, 1], so that the comparisons see the network
    # and not a field of zeros or ones
    sd["scratch.output_conv.4.weight"] = np.abs(
        sd["scratch.output_conv.4.weight"]) / 25.0
    sd["scratch.output_conv.4.bias"] = np.asarray([0.02], np.float32)
    return sd


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(the JAX predictor, the port's predictor) on one lightning-style
    checkpoint file of the synthetic state dict; one JAX compile."""
    sd = synthetic_omnidata_sd()
    path = str(tmp_path_factory.mktemp("dpt") / "omnidata_dpt_depth_v2.ckpt")
    torch.save({"state_dict": {"model." + k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return (jdpt.DPTDepthPredictor(path, size=SIZE),
            tdpt.DPTDepthPredictor(path, size=SIZE, device="cpu"))


def _net_inputs():
    return _rnd(_rng(5), 1, SIZE, SIZE, 3, scale=1.0)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    assert 0.1 < scale < 1e3, f"{what}: reference output at {scale}"
    assert (want > 0).mean() > 0.5, f"{what}: the last ReLU is mostly shut"
    err = float(np.abs(got - want).max())
    print(f"{what}: max|err| {err:.3e} at max|out| {scale:.3f}")
    assert err <= 1e-3 * scale, (what, err, scale)


def test_network_matches_flax_through_the_checkpoint_loader(nets):
    jp, tp = nets
    x = _net_inputs()
    want = np.asarray(jp._fwd(jp.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tp.model(_t(x)).numpy()
    assert got.shape == want.shape == (1, SIZE, SIZE)
    _close(got, want, "network")


def test_network_matches_flax_through_convert(nets):
    jp, _ = nets
    x = _net_inputs()
    want = np.asarray(jp._fwd(jp.params, jnp.asarray(x)))
    model = convert.dpt_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    assert not model.training
    with torch.no_grad():
        got = model(_t(x)).numpy()
    _close(got, want, "network through convert")


def test_network_matches_flax_above_the_native_grid(nets):
    """416² input: a 26×26 positional grid, resized UP from the
    checkpoint's 24×24 (the 128² cases resize it down)."""
    jp, tp = nets
    x = _rnd(_rng(7), 1, 416, 416, 3, scale=1.0)
    want = np.asarray(jp._fwd(jp.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tp.model(_t(x)).numpy()
    _close(got, want, "network at 416")


def test_convert_defaults_to_the_gpu(nets, monkeypatch):
    """dpt_params_from_numpy places the network through resolve_device: the
    GPU unless the caller names another device."""
    import inspect
    fn = convert.dpt_params_from_numpy
    assert inspect.signature(fn).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(jax.tree_util.tree_map(np.asarray, nets[0].params))


@pytest.mark.parametrize("hw", [(96, 120), (150, 200)])
def test_predictor_matches_jax_predictor(nets, hw):
    """The whole protocol on a frame smaller and one larger than the
    network's input: resize, normalise, forward, clamp, bicubic back."""
    jp, tp = nets
    img = _rng(6).uniform(size=(*hw, 3)).astype(np.float32)
    want = jp(img)
    got = tp(img)
    assert got.shape == want.shape == hw and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert 0.05 < want.min() and want.max() < 0.95 and want.std() > 0.02
    err = float(np.abs(got - want).max())
    print(f"predictor {hw}: max|err| {err:.3e} at max|depth| {want.max():.3f}")
    assert err <= 1e-3 * want.max()
    # the clamp comes BEFORE the bicubic resize, so a small overshoot stays
    assert (got >= -0.1).all() and (got <= 1.1).all()
    # and the pre-clamp output the chip check reads is the network's
    pre = tp.network_output(img)
    assert pre.shape == (SIZE, SIZE)
    np.testing.assert_array_equal(
        tdpt.resize(pre.clamp(0.0, 1.0), hw, "bicubic").numpy(), got)


def test_loader_ignores_unused_and_refuses_missing_or_misshaped(nets):
    sd = synthetic_omnidata_sd()
    model = tdpt.load_omnidata_state_dict(tdpt.DPTDepthModel(), sd)
    own = model.state_dict()
    assert "pretrained.model.norm.weight" not in own
    k = "scratch.refinenet4.resConfUnit1.conv1.weight"
    np.testing.assert_array_equal(own[k].numpy(), sd[k])
    # refinenet4's first unit may be absent (the Flax tree has none) ...
    tdpt.load_omnidata_state_dict(
        tdpt.DPTDepthModel(),
        {k: v for k, v in sd.items()
         if not k.startswith(tdpt.UNUSED_PREFIX)})
    # ... anything that a forward pass reads may not
    missing = dict(sd)
    del missing["pretrained.model.blocks.8.attn.qkv.bias"]
    with pytest.raises(KeyError, match="blocks.8.attn.qkv.bias"):
        tdpt.load_omnidata_state_dict(tdpt.DPTDepthModel(), missing)
    bad = dict(sd)
    bad["scratch.layer3_rn.weight"] = np.zeros((256, 768, 3, 3), np.float32)
    with pytest.raises(ValueError, match="layer3_rn"):
        tdpt.load_omnidata_state_dict(tdpt.DPTDepthModel(), bad)


def test_port_tree_is_the_flax_tree(nets):
    """Parameter for parameter, the port's module holds what the Flax tree
    holds (refinenet4's unused unit aside): same count of values."""
    jp, tp = nets
    n_flax = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(jp.params))
    n_port = sum(p.numel() for k, p in tp.model.named_parameters()
                 if not k.startswith(tdpt.UNUSED_PREFIX))
    assert n_flax == n_port
    assert 120e6 < n_port < 126e6


def test_seeded_predictor_is_deterministic_and_open():
    """No checkpoint path: seeded full-width weights, the same on every
    construction; a missing file still raises."""
    a = tdpt.init_seeded(tdpt.DPTDepthModel(num_blocks=1), seed=0)
    b = tdpt.init_seeded(tdpt.DPTDepthModel(num_blocks=1), seed=0)
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
    assert float(a.pretrained.model.pos_embed.detach().std()) == pytest.approx(
        0.02, rel=0.05)
    with pytest.raises(FileNotFoundError, match="omnidata checkpoint"):
        tdpt.DPTDepthPredictor("no/such/file.ckpt", device="cpu")
