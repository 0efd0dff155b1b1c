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
    CPU (plain versions), same tolerances;
  * the learned tracker in float32 (TF32 off) on the GPU against the CPU:
    one update_operator call on a 6-keyframe graph (atol 2e-4 / rtol 1e-3,
    the network parity tolerance) and one decide_batch chunk of 8 frames
    (equal decisions, deltas within 5e-3);
  * the tracer's host-sync counter: one count per synchronising call
    while a profiler runs, none from the phases' own synchronisations.
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


# -- the learned tracker (plain PyTorch on both devices) ----------------------

def _tracker_cfg(thresh):
    return {
        "dataset": "synthetic",
        "synthetic": {"n_frames": 12, "seed": 7, "motion_scale": 5.0},
        "cam": {"H": 64, "W": 96, "fx": 60.0, "fy": 60.0, "cx": 47.5,
                "cy": 31.5, "H_edge": 0, "W_edge": 0, "H_out": 64,
                "W_out": 96},
        "tracking": {"oracle": False, "buffer": 16, "beta": 0.6, "warmup": 5,
                     "mono_thres": False,
                     "motion_filter": {"thresh": thresh},
                     "multiview_filter": {"thresh": 0.01, "visible_num": 2},
                     "backend": {"BA_type": "DSPO"}},
    }


def _tracker(dev, thresh):
    """The Synthetic frames, the checkpoint's float32 network and a filter
    on `dev` holding frame 0."""
    import os
    from splatslam_tpu_torch.datasets import Synthetic
    from splatslam_tpu_torch.models.weights import load_droid_params
    from splatslam_tpu_torch.tracking.depth_video import DepthVideo
    from splatslam_tpu_torch.tracking.motion_filter import MotionFilter
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = _tracker_cfg(thresh)
    ds = Synthetic(cfg)
    model = load_droid_params(
        os.path.join(repo, "pretrained/droid_dba.msgpack"), device=dev,
        dtype=torch.float32)
    video = DepthVideo(cfg, device=dev)
    mf = MotionFilter(model, video, cfg,
                      mono_fn=lambda t, img: ds[int(t)][2])
    frames = np.stack([(np.asarray(ds[k][1]) * 255.0).astype(np.uint8)
                       for k in range(len(ds))])
    intr = np.asarray(ds.get_intrinsic())
    assert mf.track(0.0, frames[0], intr)
    return ds, model, video, mf, frames, intr


@pytest.mark.cuda
def test_update_operator_gpu_matches_cpu():
    _need_cuda()
    from splatslam_tpu_torch.ops import lie
    from splatslam_tpu_torch.tracking.factor_graph import (FactorGraph,
                                                           update_operator)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = {}
    for dev in ("cpu", "cuda"):
        ds, model, video, mf, frames, intr = _tracker(dev, -1.0)
        for k in range(1, 6):
            assert mf.track(float(k), frames[k], intr)
        s = video.state
        # GT poses relative to frame 0 and GT disparities: real flow
        for k in range(6):
            s.poses[k] = torch.as_tensor(lie.from_matrix_np(
                np.linalg.inv(ds[k][3]) @ ds[0][3]), device=dev)
            s.disps[k] = torch.as_tensor(
                1.0 / np.maximum(ds[k][2][3::8, 3::8][:8, :12], 1e-6),
                device=dev)
        g = FactorGraph(video, model, max_factors=48)
        g.add_neighborhood_factors(0, 6, r=2)
        with torch.no_grad():
            outs[dev] = update_operator(
                model, s.poses, s.disps, video.intr0, s.fmaps, s.inps, g.net,
                g.target, g._idx(g.ii), g._idx(g.jj))
    names = ("net", "target", "weight", "eta", "upmask", "uniq", "coords1")
    for name, c, k in zip(names, outs["cpu"], outs["cuda"]):
        assert k.device.type == "cuda", name
        torch.testing.assert_close(k.cpu(), c, atol=2e-4, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")
    tgt, c1 = outs["cuda"][1], outs["cuda"][6]
    assert float((tgt - c1).abs().max()) > 1e-2


@pytest.mark.cuda
def test_decide_batch_gpu_matches_cpu():
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = {}
    for dev in ("cpu", "cuda"):
        _, _, video, mf, frames, _ = _tracker(dev, 0.5)
        imgs = torch.as_tensor(frames[1:9], device=dev)
        admits, deltas, gmaps, nets, inps = mf.decide_batch(imgs, 8)
        assert gmaps.device.type == dev
        got[dev] = (admits.tolist(), np.asarray(deltas))
    assert got["cuda"][0] == got["cpu"][0]
    assert any(got["cpu"][0]) and not all(got["cpu"][0])
    np.testing.assert_allclose(got["cuda"][1], got["cpu"][1], atol=5e-3,
                               rtol=5e-3)


@pytest.mark.cuda
def test_sync_counter_counts_each_wait_while_profiled():
    """The tracer's `n.sync`: torch warns once per synchronising call in
    the sync debug mode, and each is counted where it happened, while a
    profiler runs and not before or after; the phases' own
    synchronisations are not counted."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile
    from splatslam_tpu_torch.utils.profiling import PhaseTimers
    t = PhaseTimers("cuda")
    x = torch.ones(64, device="cuda")
    with t("frontend"):
        x.sum().item()
    assert "n.sync" not in t.total
    with profile(activities=[ProfilerActivity.CUDA]):
        with t("frontend"):
            with t("fe.round"):
                for _ in range(3):
                    x.sum().item()
            bool(x.any())
            x.cpu()
    with t("mapping"):
        x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert t.total["n.sync"] == 5, t.total
    assert t.total["n.sync.fe.round"] == 3
    assert t.total["n.sync.frontend"] == 2
