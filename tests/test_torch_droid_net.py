"""DroidNet parity: the PyTorch port's network against the JAX package's on
the same numpy inputs, both in float32 on the CPU.

Random flax parameters are carried across by
`convert.droid_params_from_numpy`; the in-repo checkpoint goes through both
packages' own loaders. Tolerance everywhere: atol 2e-4, rtol 1e-3 (the JAX
suite's against the reference torch modules, tests/test_droid_net.py) —
float32 convolutions with different summation orders.

The JAX side is channel-last (B,H,W,C), the port channel-first (B,C,H,W).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.models import droid_net as jnet
from splatslam_tpu.models import init_params
from splatslam_tpu.models import weights as jweights
from splatslam_tpu_torch import convert
from splatslam_tpu_torch.models import droid_net as tnet
from splatslam_tpu_torch.models import weights as tweights
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)
H8, W8 = 8, 13          # 1/8 of 64×104; an odd width on purpose


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """(flax params, the port's DroidNet holding the same weights)."""
    params = init_params(jax.random.PRNGKey(1), H=64, W=104)
    # flax initialises biases to zero; give them values so a dropped or
    # swapped bias shows
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: a if a.ndim == 4 else jnp.asarray(
            0.1 * rng.randn(*a.shape), jnp.float32), params)
    model = tnet.DroidNet(device="cpu")
    model.load_state_dict(convert.droid_params_from_numpy(_np_tree(params)),
                          strict=True)
    return params, model


def _t(x):
    """channel-last numpy → channel-first tensor."""
    return torch.as_tensor(np.moveaxis(x, -1, 1).copy())


def _n(x):
    """channel-first tensor → channel-last numpy."""
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _case(name, params, model, rng):
    """(JAX outputs, port outputs) of one submodule on the same inputs."""
    r = lambda *s: rng.randn(*s).astype(np.float32)
    if name in ("resblock", "resblock_stride2"):
        stride = 2 if name.endswith("2") else 1
        key, planes, cin, blk = (
            ("layer2_0", 64, 32, model.fnet.layer2[0]) if stride == 2
            else ("layer3_1", 128, 128, model.fnet.layer3[1]))
        x = r(2, 12, 14, cin)
        want = jnet.ResidualBlock(planes, "instance", stride).apply(
            {"params": params["fnet"][key]}, x)
        return [want], [blk(_t(x))]
    if name in ("fnet", "cnet"):
        x = r(2, 64, 104, 3)
        norm, dim = ("instance", 128) if name == "fnet" else ("none", 256)
        want = jnet.BasicEncoder(dim, norm).apply({"params": params[name]}, x)
        return [want], [getattr(model, name)(_t(x))]
    net, inp = np.tanh(r(3, H8, W8, 128)), np.maximum(r(3, H8, W8, 128), 0)
    if name == "gru":
        inp = r(3, H8, W8, 320)
        want = jnet.ConvGRU(128).apply({"params": params["update"]["gru"]},
                                       net, inp)
        return [want], [model.update.gru(_t(net), _t(inp))]
    if name == "agg":
        ix = np.asarray([1, 0, 1])
        eta, up = jnet.GraphAgg().apply({"params": params["update"]["agg"]},
                                        net, jnp.asarray(ix), 2)
        eta_t, up_t = model.update.agg(_t(net), torch.as_tensor(ix), 2)
        return [eta, up], [eta_t.numpy(), _n(up_t)]
    corr, flow = r(3, H8, W8, 196), 3 * r(3, H8, W8, 4)
    if name == "update":
        want = jnet.UpdateModule().apply({"params": params["update"]}, net,
                                         inp, corr, flow)
        return list(want), list(model.update(_t(net), _t(inp), _t(corr),
                                             _t(flow)))
    assert name == "whole"
    x = r(2, 64, 104, 3)
    ix = np.asarray([0, 0, 1])
    fmap, cn, ci, out = jnet.DroidNet().apply(
        {"params": params}, x, net, inp, corr, flow, jnp.asarray(ix), 2)
    fm_t, cn_t, ci_t, out_t = model(_t(x), _t(net), _t(inp), _t(corr),
                                    _t(flow), torch.as_tensor(ix), 2)
    return [fmap, cn, ci, *out], [fm_t, cn_t, ci_t, *out_t]


@pytest.mark.parametrize("name", ["resblock", "resblock_stride2", "fnet",
                                  "cnet", "gru", "agg", "update", "whole"])
def test_submodule_matches_jax(nets, name):
    params, model = nets
    want, got = _case(name, params, model, np.random.RandomState(3))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g if isinstance(g, np.ndarray) else (
            _n(g) if g.dim() == 4 else g.numpy())
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_methods_match_jax(nets):
    """features / context / update_step / update_agg, the entry points the
    tracker calls."""
    params, model = nets
    rng = np.random.RandomState(5)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    net = jnet.DroidNet()
    x = r(1, 64, 104, 3)
    ap = lambda m, *a: net.apply({"params": params}, *a, method=m)
    np.testing.assert_allclose(_n(model.features(_t(x))),
                               ap(jnet.DroidNet.features, x), **TOL)
    for w, g in zip(ap(jnet.DroidNet.context, x), model.context(_t(x))):
        np.testing.assert_allclose(_n(g), w, **TOL)
    h, inp, corr = np.tanh(r(2, H8, W8, 128)), r(2, H8, W8, 128), \
        r(2, H8, W8, 196)
    # flow=None is a zero flow
    for w, g in zip(ap(jnet.DroidNet.update_step, h, inp, corr),
                    model.update_step(_t(h), _t(inp), _t(corr))):
        np.testing.assert_allclose(_n(g), w, **TOL)
    ix = np.asarray([1, 1])
    eta, up = ap(jnet.DroidNet.update_agg, h, jnp.asarray(ix), 2)
    eta_t, up_t = model.update_agg(_t(h), torch.as_tensor(ix), 2)
    np.testing.assert_allclose(eta_t.numpy(), eta, **TOL)
    np.testing.assert_allclose(_n(up_t), up, **TOL)
    # slot 0 has no edge: the mean of nothing is zero, not NaN
    assert np.isfinite(eta_t.numpy()).all()


def test_normalize_images_matches_jax():
    rng = np.random.RandomState(7)
    img = rng.rand(2, 6, 5, 3).astype(np.float32)
    want = np.asarray(jnet.normalize_images(jnp.asarray(img)))
    got = tnet.normalize_images(torch.as_tensor(img))
    np.testing.assert_allclose(_n(got), want, atol=1e-6)
    u8 = (img * 255).astype(np.uint8)
    got8 = tnet.normalize_images(torch.as_tensor(u8))
    np.testing.assert_allclose(
        _n(got8), np.asarray(jnet.normalize_images(
            jnp.asarray(u8).astype(jnp.float32) / 255.0)), atol=1e-6)


def test_compute_dtype_reads_the_environment(monkeypatch):
    monkeypatch.delenv("SPLATSLAM_F32_NET", raising=False)
    assert tnet.compute_dtype() == torch.bfloat16
    monkeypatch.setenv("SPLATSLAM_F32_NET", "1")
    assert tnet.compute_dtype() == torch.float32


# -- weights ----------------------------------------------------------------

def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_msgpack_reader_matches_flax_leaf_by_leaf():
    from flax import serialization
    path = os.path.join(REPO, "pretrained/droid_dba.msgpack")
    with open(path, "rb") as f:
        want = _flatten(serialization.msgpack_restore(f.read()))
    got = _flatten(tweights.read_msgpack_tree(path))
    assert set(got) == set(want) and len(want) == 102
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert sum(v.size for v in got.values()) == 4002565


def test_checkpoint_loaded_by_both_loaders_agrees(monkeypatch):
    """pretrained/droid_dba.msgpack through each package's own loader, then
    the whole net on one input."""
    monkeypatch.chdir(REPO)
    params = jweights.load_droid_params("pretrained/droid_dba.msgpack")
    model = tweights.load_droid_params("pretrained/droid_dba.msgpack",
                                       device="cpu", dtype=torch.float32)
    assert model.weights_source == "pretrained/droid_dba.msgpack"
    assert model.dtype == torch.float32
    want, got = _case("whole", params, model, np.random.RandomState(11))
    for w, g in zip(want, got):
        g = _n(g) if g.dim() == 4 else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def _reference_state(rng, head=4, prefix="module."):
    """A fabricated `droid.pth` state dict (shapes of the reference
    checkpoint, tests/test_weights.py)."""
    model = tnet.DroidNet(device="cpu")
    state = {}
    for k, v in model.state_dict().items():
        shape = list(v.shape)
        if k.startswith(("update.weight.2", "update.delta.2")):
            shape[0] = head
        state[prefix + k] = rng.randn(*shape).astype(np.float32)
    return state


@pytest.mark.parametrize("head,prefix", [(4, "module."), (2, "")],
                         ids=["dataparallel_4ch_heads", "presliced_heads"])
def test_droid_pth_mapping(tmp_path, head, prefix):
    """`module.` stripped, the 4-channel heads sliced to 2, values and
    shapes equal to the JAX converter's (OIHW here, HWIO there)."""
    state = _reference_state(np.random.RandomState(0), head, prefix)
    state[prefix + "not.in.the.net"] = np.zeros(3, np.float32)
    path = str(tmp_path / "droid.pth")
    torch.save({k: torch.as_tensor(v) for k, v in state.items()}, path)
    model = tweights.load_droid_params(path, device="cpu",
                                       dtype=torch.float32)
    assert model.weights_source == path
    sd = model.state_dict()
    assert sd["update.delta.2.weight"].shape == (2, 128, 3, 3)
    np.testing.assert_array_equal(sd["update.weight.2.bias"].numpy(),
                                  state[prefix + "update.weight.2.bias"][:2])
    want = _flatten(jweights.torch_state_to_params(state))
    got = {path_ + (leaf,): sd[f"{t}.{src}"].numpy()
           for t, path_ in tweights.MAPPING.items()
           for leaf, src in (("kernel", "weight"), ("bias", "bias"))
           if f"{t}.weight" in sd}
    assert set(got) == set(want)
    for k in want:
        g = got[k].transpose(2, 3, 1, 0) if k[-1] == "kernel" else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]))


def test_load_falls_back_loudly(tmp_path, monkeypatch, capsys):
    """Configured path missing → warning, then the in-repo checkpoint; no
    checkpoint at all → warning and a seeded random net."""
    monkeypatch.chdir(REPO)
    m = tweights.load_droid_params("no/such/droid.pth", device="cpu",
                                   dtype=torch.float32)
    out = capsys.readouterr().out
    assert "does not exist" in out and "loading pretrained/droid_dba" in out
    assert m.weights_source == "pretrained/droid_dba.msgpack"
    monkeypatch.chdir(tmp_path)
    gen = lambda: torch.Generator().manual_seed(3)
    a = tweights.load_droid_params("", device="cpu", generator=gen())
    b = tweights.load_droid_params("", device="cpu", generator=gen())
    assert "RANDOM tracker weights" in capsys.readouterr().out
    assert a.weights_source == "random" and a.dtype == tnet.compute_dtype()
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert float(a.fnet.conv1.weight.float().abs().sum()) > 0
