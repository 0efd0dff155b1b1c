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
