"""The CUDA kernels on the GPU (skipped without one). This file imports
torch and the port only, so it runs on a GPU machine without jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

  * B1/B2 against their plain versions: color/depth 1e-5, alpha 1e-4 (the
    early exit of saturated tiles), n_touched exact, gradients rtol 1e-3 /
    atol 1e-4 (atomics reorder the sums);
  * the same on the hard inputs of tests/composite_cases.py (overflowing
    and empty tiles, padding inside a count, K off the staging batch,
    colliding ids, saturated tiles, elongated Gaussians), with and without
    n_touched and at each number of pixels per thread the kernels are built
    for, and that any other number is refused (the
    wrappers pick it from the grid's size; these grids are all small):
    what tests/test_torch_composite_cases.py holds against the JAX package
    on the CPU. In the saturated case the gradients' absolute tolerance is
    1e-4 of each field's largest magnitude: the conic fields sum terms
    ~1e3 times the opacity field's over every pixel of the image;
  * rasterize_batch and its gradients on the GPU (kernels) against the
    CPU (plain versions), same tolerances.
"""

import numpy as np
import pytest
import torch

from splatslam_tpu_torch.ops import rasterizer as trz, raster_cuda
from composite_cases import CASES, make_case


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _composite_case(ntx, nty, seed=11, B=2, K=16, N=128):
    rng = np.random.RandomState(seed)
    Tn = ntx * nty
    ids = np.full((B, Tn, K), -1, np.int32)
    counts = rng.randint(0, K + 4, (B, Tn)).astype(np.int32)
    for b in range(B):
        for t in range(Tn):
            c = min(counts[b, t], K)
            ids[b, t, :c] = rng.randint(0, N, c)
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
    return [torch.as_tensor(x) for x in (pk, ids, counts, gout)]


@pytest.mark.cuda
@pytest.mark.parametrize("ntx,nty", [(3, 2), (4, 2)])
def test_cuda_kernels_match_plain(ntx, nty):
    _need_cuda()
    pk, ids, counts, gout = [x.cuda() for x in _composite_case(ntx, nty)]
    raster_cuda.reset_launch_counts()
    out_k, nt_k = raster_cuda.composite_fwd(pk, ids, counts, ntx)
    out_p, nt_p = trz.composite_fwd_torch(pk, ids, counts, ntx)
    torch.testing.assert_close(out_k[:, :, :4], out_p[:, :, :4], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(out_k[:, :, 4], out_p[:, :, 4], atol=1e-4,
                               rtol=0)
    assert torch.equal(nt_k, nt_p)
    g_k = raster_cuda.composite_bwd(pk, ids, counts, ntx, gout, out_k)
    g_p = trz.composite_bwd_torch(pk, ids, counts, ntx, gout, out_k)
    torch.testing.assert_close(g_k, g_p, rtol=1e-3, atol=1e-4)
    assert raster_cuda.launches == {"composite_fwd": 1, "composite_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("ppt", [
    dict(zip(raster_cuda.PIXELS_PER_THREAD, p))
    for p in zip(*raster_cuda.PIXELS_PER_THREAD.values())],
    ids=lambda p: "-".join(map(str, p.values())))
@pytest.mark.parametrize("want_touched", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernels_match_plain_on_hard_cases(name, want_touched, ppt,
                                                monkeypatch):
    _need_cuda()
    monkeypatch.setattr(raster_cuda, "pixels_per_thread",
                        lambda kernel, n_tiles: ppt[kernel])
    c = make_case(name)
    pk, ids, counts, gout = [torch.as_tensor(c[k]).cuda() for k in (
        "packets", "tile_ids", "counts", "gout")]
    ntx = c["ntx"]
    raster_cuda.reset_launch_counts()
    out_k, nt_k = raster_cuda.composite_fwd(pk, ids, counts, ntx,
                                            want_touched)
    out_p, nt_p = trz.composite_fwd_torch(pk, ids, counts, ntx, want_touched)
    torch.testing.assert_close(out_k[:, :, :4], out_p[:, :, :4], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(out_k[:, :, 4], out_p[:, :, 4], atol=1e-4,
                               rtol=0)
    assert torch.equal(nt_k, nt_p)
    assert bool(nt_k.any()) == want_touched
    g_k = raster_cuda.composite_bwd(pk, ids, counts, ntx, gout, out_k)
    g_p = trz.composite_bwd_torch(pk, ids, counts, ntx, gout, out_k)
    assert g_k.shape == g_p.shape and float(g_p.abs().max()) > 0
    for f in range(10):
        scale = max(1.0, float(g_p[..., f].abs().max())) \
            if name == "saturated" else 1.0
        torch.testing.assert_close(g_k[..., f], g_p[..., f], rtol=1e-3,
                                   atol=1e-4 * scale)
    assert raster_cuda.launches == {"composite_fwd": 1, "composite_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,ppt", [("composite_fwd", 8),
                                        ("composite_bwd", 2)])
def test_unbuilt_pixels_per_thread_is_refused(kernel, ppt, monkeypatch):
    _need_cuda()
    monkeypatch.setattr(raster_cuda, "pixels_per_thread",
                        lambda k, n_tiles: ppt if k == kernel else 4)
    pk, ids, counts, gout = [x.cuda() for x in _composite_case(3, 2)]
    raster_cuda.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        out, _ = raster_cuda.composite_fwd(pk, ids, counts, 3)
        raster_cuda.composite_bwd(pk, ids, counts, 3, gout, out)
    assert raster_cuda.launches[kernel] == 0


@pytest.mark.cuda
def test_rasterize_batch_gpu_matches_cpu():
    _need_cuda()
    rng = np.random.RandomState(2)
    N, B, H, W, K = 64, 2, 32, 48, 32
    means = np.stack([rng.uniform(-0.8, 0.8, N), rng.uniform(-0.6, 0.6, N),
                      rng.uniform(1.5, 3.0, N)], -1)
    args = [means, np.exp(rng.uniform(-3.5, -1.9, (N, 3))), rng.randn(N, 4),
            rng.uniform(0.2, 0.95, N), rng.rand(N, 3)]
    w2cs = np.tile(np.eye(4), (B, 1, 1))
    w2cs[1, :3, 3] = [0.05, -0.03, 0.1]
    rest = [rng.rand(N) > 0.1, w2cs, 0.01 * rng.randn(B, 6),
            np.asarray([40.0, 40.0, 23.5, 15.5]), np.zeros(3)]
    cts = [torch.as_tensor(rng.randn(B, H, W, 3), dtype=torch.float32),
           torch.as_tensor(rng.randn(B, H, W), dtype=torch.float32)]

    def run(dev):
        a = [torch.as_tensor(x, dtype=torch.float32, device=dev)
             .requires_grad_() for x in args]
        r = [torch.as_tensor(x, device=dev) if x.dtype == bool else
             torch.as_tensor(x, dtype=torch.float32, device=dev)
             for x in rest]
        out = trz.rasterize_batch(*a, *r, H=H, W=W, K=K)
        loss = ((out.color * cts[0].to(dev)).sum()
                + (out.depth * cts[1].to(dev)).sum() + out.alpha.sum())
        grads = torch.autograd.grad(loss, a)
        return [out.color, out.depth, out.alpha, *grads], out.n_touched

    got, nt_g = run("cuda")
    want, nt_c = run("cpu")
    assert torch.equal(nt_g.cpu(), nt_c)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.detach().cpu(), w.detach(), rtol=1e-3,
                                   atol=1e-4)
