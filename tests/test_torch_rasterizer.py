"""Rasterizer of the PyTorch port against splatslam_tpu.ops.rasterizer.

  * the plain versions of B1/B2 (composite_fwd_torch / composite_bwd_torch)
    against the Pallas kernels in interpret mode, as
    tests/test_rasterizer.py runs them: forward atol 1e-5, n_touched
    exact, gradients rtol/atol 2e-4 (that file's tolerances);
  * bin_gaussians_batch on tie-free depths: identical lists and counts;
  * rasterize_batch outputs and gradients (means3D, scales, rotations,
    opacities, colors, taus) against jax.grad of the JAX rasterize_batch
    (its XLA path on the CPU), atol 1e-4;
  * the CUDA wrapper's dispatch: a CPU tensor runs the plain version and
    never counts a kernel launch.
The kernels themselves are checked against the plain versions on the GPU
(tests/test_torch_cuda.py, and chip_smoke.py at full size).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.ops import rasterizer as jrz, raster_pallas as jrp
from splatslam_tpu_torch.ops import rasterizer as trz, raster_cuda
from test_torch_threads import few_torch_threads  # noqa: F401

T = lambda x: torch.as_tensor(np.array(x))


def _composite_case(ntx, nty, seed=11, B=2, K=16, N=128):
    """Random tile lists and packets (the JAX suite's generator)."""
    rng = np.random.RandomState(seed)
    Tn = ntx * nty
    ids = np.full((B, Tn, K), -1, np.int32)
    counts = np.zeros((B, Tn), np.int32)
    for b in range(B):
        for t in range(Tn):
            c = rng.randint(0, K + 4)
            counts[b, t] = c
            ids[b, t, :min(c, K)] = rng.randint(0, N, min(c, K))
    pk = np.zeros((B, N, 10), np.float32)
    pk[..., 0] = rng.rand(B, N) * ntx * 16.0
    pk[..., 1] = rng.rand(B, N) * nty * 16.0
    pk[..., 2] = 0.05 + 0.1 * rng.rand(B, N)
    pk[..., 3] = 0.01 * rng.randn(B, N)
    pk[..., 4] = 0.05 + 0.1 * rng.rand(B, N)
    pk[..., 5:8] = rng.rand(B, N, 3)
    pk[..., 8] = 0.1 + 0.85 * rng.rand(B, N)
    pk[..., 9] = 1.0 + rng.rand(B, N)
    gout = rng.randn(B, Tn, 5, 256).astype(np.float32)
    return pk, ids, counts, gout


@pytest.mark.parametrize("ntx,nty", [(3, 2), (4, 2)])
def test_plain_composite_matches_pallas_interpret(ntx, nty):
    pk, ids, counts, gout = _composite_case(ntx, nty)
    B, N, _ = pk.shape
    Tn = ntx * nty
    tl_T, ids_smem, counts_flat = jrz._pallas_prep(
        jnp.asarray(ids), jnp.asarray(counts), jnp.asarray(pk))
    out_j, nt_j = jrp.composite_fwd_pallas(counts_flat, tl_T, ids_smem, B,
                                           Tn, ntx, N, interpret=True)
    out_t, nt_t = trz.composite_fwd_torch(T(pk), T(ids), T(counts), ntx)
    np.testing.assert_allclose(out_t.numpy().reshape(B * Tn, 5, 256),
                               np.asarray(out_j)[:, :5], atol=1e-5)
    np.testing.assert_array_equal(
        nt_t.numpy(), np.asarray(nt_j[:, :, 0, :]).reshape(B, N))

    g = gout.reshape(B * Tn, 5, 256)
    gpack = jnp.concatenate([jnp.asarray(g), jnp.zeros((B * Tn, 3, 256))], 1)
    acc = jrp.composite_bwd_pallas(counts_flat, tl_T, ids_smem, gpack,
                                   out_j, B, Tn, ntx, N, interpret=True)
    g_j = np.asarray(acc.transpose(0, 2, 1, 3).reshape(B, 16, N)[:, :10]
                     ).transpose(0, 2, 1)
    g_t = trz.composite_bwd_torch(T(pk), T(ids), T(counts), ntx, T(gout),
                                  out_t)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=2e-4, atol=2e-4)


def test_bin_gaussians_batch_matches_jax():
    rng = np.random.RandomState(5)
    B, N, ntx, nty, K = 2, 300, 6, 4, 24
    m2d = np.stack([rng.rand(B, N) * ntx * 16 * 1.2 - 8,
                    rng.rand(B, N) * nty * 16 * 1.2 - 8], -1).astype(
        np.float32)
    radius = np.ceil(rng.rand(B, N) * 40).astype(np.float32)
    # tie-free: a permutation of evenly spaced depths → distinct 16-bit keys
    depth = np.stack([1.0 + rng.permutation(N) / N for _ in range(B)]
                     ).astype(np.float32)
    visible = rng.rand(B, N) > 0.1
    ids_j, cnt_j = jrz.bin_gaussians_batch(
        jnp.asarray(m2d), jnp.asarray(radius), jnp.asarray(depth),
        jnp.asarray(visible), ntx, nty, K)
    ids_t, cnt_t = trz.bin_gaussians_batch(T(m2d), T(radius), T(depth),
                                           T(visible), ntx, nty, K)
    assert (np.asarray(cnt_j) > K).any()       # the overflow path is hit
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def _scene(seed=2, N=64, B=2):
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, N), rng.uniform(-0.6, 0.6, N),
                      rng.uniform(1.5, 3.0, N)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.03), np.log(0.15), (N, 3))
                    ).astype(np.float32)
    rots = rng.randn(N, 4).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, N).astype(np.float32)
    cols = rng.rand(N, 3).astype(np.float32)
    alive = rng.rand(N) > 0.1
    w2cs = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    w2cs[1, :3, 3] = [0.05, -0.03, 0.1]
    taus = (0.01 * rng.randn(B, 6)).astype(np.float32)
    intr = np.asarray([40.0, 40.0, 23.5, 15.5], np.float32)
    return (means, scales, rots, opac, cols, alive, w2cs, taus, intr,
            np.zeros(3, np.float32))


def test_rasterize_batch_and_grads_match_jax():
    H, W, K = 32, 48, 32
    args = _scene()
    B = args[6].shape[0]
    rng = np.random.RandomState(9)
    cts = [rng.randn(B, H, W, 3), rng.randn(B, H, W), rng.randn(B, H, W)]
    cts = [c.astype(np.float32) for c in cts]
    diff = (0, 1, 2, 3, 4, 7)   # means3D scales rotations opac colors taus

    def loss_j(*d):
        a = list(args)
        for i, x in zip(diff, d):
            a[i] = x
        out = jrz.rasterize_batch(*[jnp.asarray(x) for x in a], H=H, W=W,
                                  K=K)
        loss = ((out.color * cts[0]).sum() + (out.depth * cts[1]).sum()
                + (out.alpha * cts[2]).sum())
        return loss, out

    (_, out_j), g_j = jax.value_and_grad(
        loss_j, argnums=tuple(range(len(diff))), has_aux=True)(
        *[jnp.asarray(args[i]) for i in diff])

    a = [T(x) for x in args]
    for i in diff:
        a[i].requires_grad_(True)
    out_t = trz.rasterize_batch(*a, H=H, W=W, K=K)
    loss = ((out_t.color * T(cts[0])).sum() + (out_t.depth * T(cts[1])).sum()
            + (out_t.alpha * T(cts[2])).sum())
    g_t = torch.autograd.grad(loss, [a[i] for i in diff])

    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(out_t, name).detach().numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   atol=1e-4)
    np.testing.assert_array_equal(out_t.n_touched.numpy(),
                                  np.asarray(out_j.n_touched))
    assert out_t.n_touched.sum() > 0
    for gt, gj in zip(g_t, g_j):
        assert np.abs(np.asarray(gj)).max() > 0
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("which", ["composite_fwd", "composite_bwd"])
def test_cuda_wrapper_runs_plain_version_on_cpu(which):
    pk, ids, counts, gout = _composite_case(3, 2)
    raster_cuda.reset_launch_counts()
    before = trz.plain_calls[which]
    out, _ = raster_cuda.composite_fwd(T(pk), T(ids), T(counts), 3)
    if which == "composite_bwd":
        before = trz.plain_calls[which]
        raster_cuda.composite_bwd(T(pk), T(ids), T(counts), 3, T(gout), out)
    assert trz.plain_calls[which] == before + 1
    assert raster_cuda.launches == {"composite_fwd": 0, "composite_bwd": 0}
