"""The port's small public helpers against the JAX package's:
ops/rasterizer.rasterize (the one-camera wrapper) and bin_gaussians,
mapping/gaussians.num_alive, mapping/losses.l1_loss, image_gradient and
image_gradient_mask, Camera.R / .T / .update_RT, and DepthVideo.get_pose,
get_depth_and_pose and get_depth_scale_and_shift.

Tolerances are those of the modules' existing parity tests: the rendered
image atol 1e-4 and n_touched exact (test_torch_rasterizer.py), binning on
tie-free depths exact, image filters 1e-6 (float32 3x3 sums), poses rtol
1e-6, the scale/shift fit rtol 1e-4 / atol 1e-5 (test_torch_ba.py's: float32
normal equations); host numpy bookkeeping equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.mapping import camera as jcam, gaussians as jG
from splatslam_tpu.mapping import losses as jL
from splatslam_tpu.ops import lie as jlie, rasterizer as jrz
from splatslam_tpu.tracking import depth_video as jdv
from splatslam_tpu_torch.convert import (gaussian_state_from_numpy,
                                         video_state_from_numpy)
from splatslam_tpu_torch.mapping import camera as tcam, gaussians as tG
from splatslam_tpu_torch.mapping import losses as tL
from splatslam_tpu_torch.ops import rasterizer as trz
from splatslam_tpu_torch.tracking import depth_video as tdv
from test_torch_threads import few_torch_threads  # noqa: F401

T = lambda x: torch.as_tensor(np.array(x))


def _cloud(seed=4, N=80):
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, N), rng.uniform(-0.6, 0.6, N),
                      1.5 + 1.5 * rng.permutation(N) / N], -1)
    return [a.astype(np.float32) for a in (
        means, np.exp(rng.uniform(np.log(0.03), np.log(0.15), (N, 3))),
        rng.randn(N, 4), rng.uniform(0.2, 0.95, N), rng.rand(N, 3))] + [
        rng.rand(N) > 0.1]


def test_rasterize_one_camera_matches_jax():
    """Outputs and the screen-space gradient (means2d_dummy), tau ≠ 0."""
    H, W, K = 40, 56, 32
    means, scales, rots, opac, cols, alive = _cloud()
    N = means.shape[0]
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.02, -0.01, 0.05]
    tau = (0.01 * np.random.RandomState(1).randn(6)).astype(np.float32)
    intr = np.asarray([45.0, 45.0, 27.5, 19.5], np.float32)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    args = (means, scales, rots, opac, cols, alive, w2c, tau, intr, bg)
    dummy = np.zeros((N, 2), np.float32)

    def loss_j(d):
        out = jrz.rasterize(*[jnp.asarray(a) for a in args], d, H=H, W=W,
                            K=K)
        return out.color.sum() + out.depth.sum(), out

    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(dummy))
    d_t = T(dummy).requires_grad_(True)
    out_t = trz.rasterize(*[T(a) for a in args], d_t, H=H, W=W, K=K)
    g_t, = torch.autograd.grad(out_t.color.sum() + out_t.depth.sum(), d_t)
    for f in dataclasses.fields(out_t):
        got = getattr(out_t, f.name).detach().numpy()
        want = np.asarray(getattr(out_j, f.name))
        assert got.shape == want.shape, f.name
        if f.name == "n_touched":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f.name)
    assert out_t.n_touched.sum() > 0 and np.abs(np.asarray(g_j)).max() > 0
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4,
                               rtol=1e-3)


def test_bin_gaussians_one_camera_matches_jax():
    rng = np.random.RandomState(6)
    N, ntx, nty, K = 200, 5, 3, 20
    m2d = np.stack([rng.rand(N) * ntx * 16 * 1.2 - 8,
                    rng.rand(N) * nty * 16 * 1.2 - 8], -1).astype(np.float32)
    radius = np.ceil(rng.rand(N) * 30).astype(np.float32)
    depth = (1.0 + rng.permutation(N) / N).astype(np.float32)
    visible = rng.rand(N) > 0.1
    ids_j, cnt_j = jrz.bin_gaussians(jnp.asarray(m2d), jnp.asarray(radius),
                                     jnp.asarray(depth), jnp.asarray(visible),
                                     ntx, nty, K)
    ids_t, cnt_t = trz.bin_gaussians(T(m2d), T(radius), T(depth), T(visible),
                                     ntx, nty, K)
    assert (np.asarray(cnt_j) > K).any()
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_num_alive_matches_jax():
    st_j = jG.make_state(64)
    st_j = dataclasses.replace(
        st_j, alive=jnp.asarray(np.random.RandomState(2).rand(64) > 0.3))
    st_t = gaussian_state_from_numpy(
        {f.name: np.asarray(getattr(st_j, f.name))
         for f in dataclasses.fields(st_j)}, device="cpu")
    assert tG.num_alive(st_t) == jG.num_alive(st_j) > 0
    assert isinstance(tG.num_alive(st_t), int)


@pytest.mark.parametrize("shape", [(20, 28), (20, 28, 3)],
                         ids=["gray", "rgb"])
def test_image_losses_match_jax(shape):
    rng = np.random.RandomState(3)
    a = rng.rand(*shape).astype(np.float32)
    b = rng.rand(*shape).astype(np.float32)
    a[2:6, 3:9] = 0.004        # a patch below eps for the mask
    np.testing.assert_allclose(float(tL.l1_loss(T(a), T(b))),
                               float(jL.l1_loss(jnp.asarray(a),
                                                jnp.asarray(b))), rtol=1e-6)
    for got, want in zip(tL.image_gradient(T(a)),
                         jL.image_gradient(jnp.asarray(a))):
        assert got.shape == want.shape == shape[:2]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    gm, gm2 = tL.image_gradient_mask(T(a))
    jm, jm2 = jL.image_gradient_mask(jnp.asarray(a))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(gm2.numpy(), np.asarray(jm2))
    assert 0 < gm.sum() < gm.numel()


def test_camera_pose_accessors_match_jax():
    rng = np.random.RandomState(5)
    w2c = np.eye(4)
    w2c[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    w2c[:3, 3] = rng.randn(3)
    img = rng.rand(8, 12, 3).astype(np.float32)
    cj = jcam.make_camera(3, img, None, w2c)
    ct = tcam.make_camera(3, img, None, w2c, device="cpu")
    np.testing.assert_array_equal(ct.R, cj.R)
    np.testing.assert_array_equal(ct.T, cj.T)
    R2 = np.linalg.qr(rng.randn(3, 3))[0]
    t2 = rng.randn(3)
    cj.update_RT(R2, t2)
    ct.update_RT(R2, t2)
    np.testing.assert_array_equal(ct.w2c, cj.w2c)
    assert ct.w2c.dtype == cj.w2c.dtype == np.float64
    np.testing.assert_array_equal(ct.R, R2)
    np.testing.assert_array_equal(ct.w2c_gt, w2c)


def _videos():
    cfg = {"cam": {"H_out": 48, "W_out": 64},
           "tracking": {"buffer": 6, "backend": {"BA_type": "DSPO"},
                        "mono_thres": False}}
    vj = jdv.DepthVideo(cfg)
    rng = np.random.RandomState(7)
    st = vj.state
    poses = np.asarray(st.poses).copy()
    poses[:4] = np.asarray(jlie.exp(jnp.asarray(
        rng.randn(4, 6).astype(np.float32) * 0.2)))
    upd = dict(poses=poses,
               disps_up=0.2 + rng.rand(*st.disps_up.shape),
               valid_depth_mask=rng.rand(*st.valid_depth_mask.shape) > 0.3)
    vj.state = dataclasses.replace(st, **{k: jnp.asarray(v, getattr(
        st, k).dtype) for k, v in upd.items()})
    vt = tdv.DepthVideo(cfg, device="cpu")
    vt.state = video_state_from_numpy(
        {f: np.asarray(getattr(vj.state, f))
         for f in vj.state.__dataclass_fields__}, device="cpu")
    return vj, vt, rng


def test_depth_video_getters_match_jax():
    vj, vt, rng = _videos()
    for i in range(4):
        np.testing.assert_allclose(vt.get_pose(i), vj.get_pose(i),
                                   rtol=1e-6, atol=1e-7)
        for got, want in zip(vt.get_depth_and_pose(i),
                             vj.get_depth_and_pose(i)):
            assert got.shape == np.shape(want)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    est = (1.0 + rng.rand(48, 64)).astype(np.float32)
    mono = (0.5 * est + 0.2 + 0.01 * rng.randn(48, 64)).astype(np.float32)
    wts = (rng.rand(48, 64) > 0.2).astype(np.float32)
    got = vt.get_depth_scale_and_shift(2, mono, est, wts)
    want = vj.get_depth_scale_and_shift(2, jnp.asarray(mono),
                                        jnp.asarray(est), jnp.asarray(wts))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert all(isinstance(x, float) for x in got)
    for f in ("depth_scale", "depth_shift"):
        np.testing.assert_allclose(getattr(vt.state, f).numpy(),
                                   np.asarray(getattr(vj.state, f)),
                                   rtol=1e-4, atol=1e-5)
