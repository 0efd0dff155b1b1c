"""Mapping of the PyTorch port against splatslam_tpu.mapping.

SSIM/PSNR, one Adam step, densify-and-prune fed the JAX run's own split
noise, and one map_step plus a 4-iteration map_step_n starting from the
same Gaussian map (carried across by convert.gaussian_state_from_numpy):
the loss and every updated parameter must match to rtol 1e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.mapping import gaussians as jG, losses as jL
from splatslam_tpu.mapping import mapper as jM
from splatslam_tpu_torch.mapping import gaussians as tG, losses as tL
from splatslam_tpu_torch.mapping import mapper as tM
from splatslam_tpu_torch.convert import gaussian_state_from_numpy
from test_torch_threads import few_torch_threads  # noqa: F401

T = lambda x: torch.as_tensor(np.array(x))
H, W, K = 32, 48, 32
INTR = np.asarray([40.0, 40.0, 23.5, 15.5], np.float32)


def _jax_state(seed=0, C=256, n_alive=200):
    """A random JAX GaussianState in front of the cameras; depths are a
    permutation of evenly spaced values, so the binning sort has no ties."""
    rng = np.random.RandomState(seed)
    st = jG.make_state(C)
    xyz = np.stack([rng.uniform(-0.8, 0.8, C), rng.uniform(-0.6, 0.6, C),
                    1.5 + 1.5 * rng.permutation(C) / C], -1)
    upd = dict(
        xyz=xyz, f_dc=rng.randn(C, 3) * 0.5,
        opacity=rng.uniform(-1.0, 2.0, (C, 1)),
        scaling=np.log(rng.uniform(0.02, 0.12, (C, 3))),
        rotation=rng.randn(C, 4), alive=np.arange(C) < n_alive,
        kf_id=rng.randint(0, 3, C),
        grad_accum=rng.rand(C) * 4e-3, denom=rng.randint(0, 3, C),
        max_radii2D=rng.rand(C) * 30)
    upd = {k: jnp.asarray(v, getattr(st, k).dtype) for k, v in upd.items()}
    return dataclasses.replace(st, **upd)


def _as_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _assert_state_close(st_t, st_j, rtol, atol, fields=None):
    for name, want in _as_numpy(st_j).items():
        if fields is not None and name not in fields:
            continue
        got = getattr(st_t, name).detach().cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)


def test_ssim_psnr_match_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(24, 40, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(24, 40, 3), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tL.ssim(T(a), T(b))),
                               float(jL.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(tL.psnr(T(a), T(b), T(b > 0.2))),
        float(jL.psnr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(b > 0.2))),
        rtol=1e-5)


def test_adam_step_matches_jax():
    st_j = _jax_state()
    rng = np.random.RandomState(1)
    grads = {n: rng.randn(*getattr(st_j, n).shape).astype(np.float32)
             for n in jG.PARAM_NAMES}
    lrs = dict(xyz=1e-3, f_dc=2.5e-3, f_rest=1e-4, opacity=0.05,
               scaling=6e-3, rotation=1e-3)
    st_t = gaussian_state_from_numpy(_as_numpy(st_j), device="cpu")
    for step in (1, 2):
        st_j = jG.adam_step(st_j, {k: jnp.asarray(v) for k, v in
                                   grads.items()}, lrs, jnp.asarray(step))
        tG.adam_step(st_t, {k: T(v) for k, v in grads.items()}, lrs, step)
    _assert_state_close(st_t, st_j, rtol=1e-5, atol=1e-6)


def test_densify_and_prune_shared_noise():
    st_j = _jax_state(seed=2)
    st_t = gaussian_state_from_numpy(_as_numpy(st_j), device="cpu")
    key = jax.random.PRNGKey(4)
    # the JAX function's own split noise, drawn the way it draws it
    k, noise = key, []
    for _ in range(2):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (st_j.xyz.shape[0],
                                                        3))))
    args = (2e-4, 0.3, 6.0, 20, 0.01)
    out_j = jM.G.densify_and_prune(st_j, key, *args)
    out_t = tG.densify_and_prune(st_t, *args, noise=T(np.stack(noise)))
    assert int(out_j.alive.sum()) != int(st_j.alive.sum())
    _assert_state_close(out_t, out_j, rtol=1e-5, atol=1e-6)


def _cams(seed=3, B=2):
    rng = np.random.RandomState(seed)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    w2cs[1, :3, 3] = [0.05, -0.03, 0.1]
    images = rng.rand(B, H, W, 3).astype(np.float32)
    depths = (2.0 + 0.3 * rng.rand(B, H, W)).astype(np.float32)
    exposure = (0.05 * rng.randn(B, 2)).astype(np.float32)
    use_exp = np.asarray([False] + [True] * (B - 1))
    valid = np.ones(B, bool)
    pose_mask = np.zeros(B, bool)
    return w2cs, images, depths, exposure, use_exp, valid, pose_mask


LRS = dict(xyz=9.6e-4, f_dc=2.5e-3, f_rest=1.25e-4, opacity=0.05,
           scaling=6e-3, rotation=1e-3)


@pytest.mark.parametrize("use_ssim", [False, True], ids=["l1", "ssim"])
def test_map_step_matches_jax(use_ssim):
    st_j = _jax_state(seed=5)
    st_t = gaussian_state_from_numpy(_as_numpy(st_j), device="cpu")
    cams = _cams()
    B = cams[0].shape[0]
    z2, z6 = np.zeros((B, 2), np.float32), np.zeros((B, 6), np.float32)
    kw = dict(H=H, W=W, K=K, use_ssim=use_ssim, alpha=0.8)
    out_j = jM.map_step(
        st_j, (jnp.asarray(z2), jnp.asarray(z2)),
        (jnp.asarray(z6), jnp.asarray(z6)),
        *[jnp.asarray(c) for c in cams], jnp.asarray(INTR), LRS,
        (jnp.asarray(5e-4), jnp.asarray(1.5e-3)), jnp.asarray(1),
        jnp.asarray(10.0), **kw)
    out_t = tM.map_step(
        st_t, (T(z2), T(z2)), (T(z6), T(z6)), *[T(c) for c in cams],
        T(INTR), LRS, (5e-4, 1.5e-3), 1, 10.0, **kw)
    np.testing.assert_allclose(float(out_t[-1]), float(out_j[-1]),
                               rtol=1e-5)
    _assert_state_close(out_t[0], out_j[0], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(out_t[4].numpy(), np.asarray(out_j[4]),
                               rtol=1e-3, atol=1e-5)       # exposure
    np.testing.assert_array_equal(out_t[6].numpy(), np.asarray(out_j[6]))


def test_map_step_n_matches_jax():
    st_j = _jax_state(seed=6)
    st_t = gaussian_state_from_numpy(_as_numpy(st_j), device="cpu")
    cams = _cams(seed=7)
    B = cams[0].shape[0]
    z2, z6 = np.zeros((B, 2), np.float32), np.zeros((B, 6), np.float32)
    lr_sched = (9.6e-4, 9.6e-6, 0.01, 30000)
    kw = dict(H=H, W=W, K=K, use_ssim=False, alpha=0.8, lr_sched=lr_sched,
              rebin_every=2)
    fixed = dict(LRS, xyz=0.0)
    out_j = jM.map_step_n(
        st_j, (jnp.asarray(z2), jnp.asarray(z2)),
        (jnp.asarray(z6), jnp.asarray(z6)),
        *[jnp.asarray(c) for c in cams], jnp.asarray(INTR), fixed,
        (jnp.asarray(5e-4), jnp.asarray(1.5e-3)), jnp.asarray(7),
        jnp.asarray(4), jnp.asarray(10.0), **kw)
    out_t = tM.map_step_n(
        st_t, (T(z2), T(z2)), (T(z6), T(z6)), *[T(c) for c in cams],
        T(INTR), fixed, (5e-4, 1.5e-3), 7, 4, 10.0, **kw)
    np.testing.assert_allclose(float(out_t[-1]), float(out_j[-1]),
                               rtol=1e-3)
    _assert_state_close(out_t[0], out_j[0], rtol=1e-3, atol=1e-5,
                        fields=("xyz", "f_dc", "opacity", "scaling",
                                "rotation", "alive", "grad_accum", "denom",
                                "max_radii2D"))


def _render_inputs(seed=8, B=2):
    st = gaussian_state_from_numpy(_as_numpy(_jax_state(seed=seed)),
                                   device="cpu")
    w2cs = T(_cams(seed=seed, B=B)[0])
    rng = np.random.RandomState(seed)
    taus = torch.as_tensor(0.01 * rng.randn(B, 6), dtype=torch.float32)
    dummy = torch.zeros((B, st.capacity, 2))
    leaves = [st.xyz, torch.exp(st.scaling), st.rotation,
              torch.sigmoid(st.opacity)[:, 0], tG.get_colors_dc(st), taus,
              dummy]
    return [x.clone().requires_grad_(True) for x in leaves], st.alive, w2cs


def test_render_pieces_compose_to_rasterize_batch():
    """project_packets, the compositor and tiles_to_image, called one
    after the other, give rasterize_batch's outputs and gradients bit for
    bit."""
    from splatslam_tpu_torch.ops import rasterizer as rz
    (xyz, scal, rot, opac, cols, taus, dummy), alive, w2cs = \
        _render_inputs()
    intr, bg = T(INTR), torch.tensor([0.1, 0.2, 0.3])
    leaves = [xyz, scal, rot, opac, cols, taus, dummy]
    want = rz.rasterize_batch(xyz, scal, rot, opac, cols, alive, w2cs, taus,
                              intr, bg, dummy, H=H, W=W, K=K)
    packets, means2d, depth_z, radius, visible, radii = rz.project_packets(
        xyz, scal, rot, opac, cols, alive, w2cs, taus, intr, dummy, H=H,
        W=W)
    ntx, nty = (W + 15) // 16, (H + 15) // 16
    with torch.no_grad():
        ids, counts = rz.bin_gaussians_batch(
            means2d, rz._bin_radius(radius, opac), depth_z, visible, ntx,
            nty, K)
    out, n_touched = rz.composite(packets, ids, counts, W, True)
    color, depth, alpha = rz.tiles_to_image(out, bg, H=H, W=W)
    got = dict(color=color, depth=depth, alpha=alpha, radii=radii,
               n_touched=n_touched, means2d=means2d)
    for name, x in got.items():
        assert torch.equal(x, getattr(want, name)), name
    grads = [torch.autograd.grad(
        (c * 0.3).sum() + d.sum() + (a ** 2).sum(), leaves,
        retain_graph=True) for c, d, a in (
            (want.color, want.depth, want.alpha), (color, depth, alpha))]
    for name, a, b in zip("xyz scal rot opac cols taus dummy".split(),
                          *grads):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("opt_poses", [False, True], ids=["map", "poses"])
def test_split_step_matches_step_shards(opt_poses):
    """Three iterations of the split step (pieces A, compositor, B, C, as
    the graph path runs them; its learning rates and bias corrections read
    from a device buffer) against three of _step_shards from the same map
    and cameras, to test_map_step_n_matches_jax's tolerances."""
    st_e = gaussian_state_from_numpy(_as_numpy(_jax_state(seed=9)),
                                     device="cpu")
    st_s = gaussian_state_from_numpy(_as_numpy(_jax_state(seed=9)),
                                     device="cpu")
    w2cs, images, depths, exposure, use_exp, valid, _ = [
        T(x) for x in _cams(seed=10)]
    B = w2cs.shape[0]
    pose_mask = torch.tensor([False, True])

    def cams():
        z = lambda n: torch.zeros((B, n))
        return tM._Cams(w2cs.clone(), images, depths, exposure.clone(),
                        use_exp, valid, pose_mask, z(2), z(2), z(6), z(6),
                        T(INTR))

    c_e, c_s = cams(), cams()
    cam_lrs = (5e-4, 1.5e-3)
    lrs_at = lambda step: dict(LRS, xyz=tG.xyz_lr(step, 9.6e-4, 9.6e-6,
                                                  0.01, 30000))
    kw = dict(H=H, W=W, use_ssim=False, alpha=0.8, opt_poses=opt_poses,
              sh_degree=0)
    bin_kw = dict(H=H, W=W, K=K, rebin_every=8, max_span=4, margin=4.0)
    sp = tM._SplitStep(st_s, B, iso_weight=10.0, **kw)
    sp.load(st_s, c_s, tM._split_scalars(lrs_at, cam_lrs, 7, 3))
    for i in range(3):
        c_e.tile_ids, c_e.tile_counts = tM._rebin(st_e, c_e.w2cs, T(INTR),
                                                  **bin_kw)
        tM._step_shards(st_e, [], [(0, c_e)], lrs_at(7 + i), cam_lrs,
                        8 + i, 10.0, K=K, want_touched=False, max_span=4,
                        **kw)
        sp.iterate(i, *tM._rebin(sp.s, sp.cam.w2cs, T(INTR), **bin_kw))
    sp.store(st_s, c_s)
    moved = st_e.xyz - T(np.asarray(_jax_state(seed=9).xyz))
    assert float(moved.abs().max()) > 1e-5
    for name in tM._MAP_OUT:
        np.testing.assert_allclose(getattr(st_s, name).numpy(),
                                   getattr(st_e, name).numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    for name in tM._Cams.STATE:
        np.testing.assert_allclose(getattr(c_s, name).numpy(),
                                   getattr(c_e, name).numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    if opt_poses:
        assert float((c_e.w2cs - w2cs).abs().max()) > 0
