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
    while a profiler runs, none from the phases' own synchronisations;
  * the mapper's graph path: 20 replayed iterations against the eager
    ones (crossing rebins, a camera-count change and a replaced map), one
    capture per key, no host sync in a replay, and B1/B2 launch records
    that pair with the device trace's launches (the kernel rooflines);
  * DSPO stage 2's kernels (csrc/dspo.cu) against their plain versions on
    the inputs of tests/dspo_cases.py (the cells' shapes and the hard
    cases): an iteration within twice the float32 plain version's distance
    from a float64 run (+1e-6), the same frames rejected; the multiview
    count equal; and one update_rounds call with stage-1 and stage-2
    rounds on the card against the CPU (atol 2e-4 / rtol 1e-3).
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


# -- the map iteration replayed from CUDA graphs ------------------------------

MAP_H, MAP_W, MAP_K, MAP_C = 64, 96, 64, 4096


def _map_state(seed=0, n_alive=3000):
    """A random map of MAP_C rows in front of the cameras, on the card."""
    from splatslam_tpu_torch.mapping import gaussians as G
    rng = np.random.RandomState(seed)
    C = MAP_C
    st = G.make_state(C, device="cuda")
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device="cuda")
    st.xyz[:] = t(np.stack([rng.uniform(-0.8, 0.8, C),
                            rng.uniform(-0.6, 0.6, C),
                            1.5 + 1.5 * rng.permutation(C) / C], -1))
    st.f_dc[:] = t(rng.randn(C, 3) * 0.5)
    st.opacity[:] = t(rng.uniform(-1.0, 2.0, (C, 1)))
    st.scaling[:] = t(np.log(rng.uniform(0.01, 0.06, (C, 3))))
    st.rotation[:] = t(rng.randn(C, 4))
    st.alive[:] = torch.arange(C, device="cuda") < n_alive
    return st


def _map_cams(B, seed=1):
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device="cuda")
    w2cs = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    w2cs[:, :3, 3] = 0.05 * rng.randn(B, 3)
    return dict(w2cs=t(w2cs), images=t(rng.rand(B, MAP_H, MAP_W, 3)),
                depths=t(2.0 + 0.3 * rng.rand(B, MAP_H, MAP_W)),
                exposure=t(0.05 * rng.randn(B, 2)),
                use_exposure=torch.arange(B, device="cuda") > 0,
                cam_valid=torch.ones(B, dtype=torch.bool, device="cuda"))


def _map_segments(devices):
    """20 mapping iterations of map_step_n from one map: 8 over two
    cameras (rebins at iterations 0, 3, 6), densify_and_prune and a fixed
    prune replacing every tensor of the map, 8 over three cameras, 4 over
    the first two again. `devices` None takes the graph path; a
    one-device list the eager one. Returns the map and the exposures."""
    from splatslam_tpu_torch.mapping import gaussians as G
    from splatslam_tpu_torch.mapping import mapper as M
    st = _map_state()
    intr = torch.tensor([60.0, 60.0, 47.5, 31.5], device="cuda")
    lrs = dict(xyz=0.0, f_dc=2.5e-3, f_rest=1.25e-4, opacity=0.05,
               scaling=6e-3, rotation=1e-3)
    expos = []
    step = 0
    for k, (B, n) in enumerate(((2, 8), (3, 8), (2, 4))):
        c = _map_cams(B, seed=k)
        z2 = torch.zeros(B, 2, device="cuda")
        z6 = torch.zeros(B, 6, device="cuda")
        out = M.map_step_n(
            st, (z2, z2), (z6, z6), c["w2cs"], c["images"], c["depths"],
            c["exposure"], c["use_exposure"], c["cam_valid"],
            torch.zeros(B, dtype=torch.bool, device="cuda"), intr, lrs,
            (5e-4, 1.5e-3), step, n, 10.0, H=MAP_H, W=MAP_W, K=MAP_K,
            use_ssim=False, alpha=0.8,
            lr_sched=(9.6e-4, 9.6e-6, 0.01, 30000), rebin_every=3,
            devices=devices)
        st, expos = out[0], expos + [out[4]]
        step += n
        if k == 0:
            # thresholds that select nothing: the same map in every run,
            # in new tensors
            st = G.densify_and_prune(st, 1e9, 0.0, 6.0, None)
            drop = torch.zeros(MAP_C, dtype=torch.bool, device="cuda")
            drop[::7] = True
            st = G.prune_by_mask(st, drop)
    return st, expos


@pytest.mark.cuda
def test_graphed_map_segments_match_eager():
    """The graph path (devices None) against the eager one (a one-device
    list) over 20 iterations that cross rebins, a change of the camera
    count and a replaced map. B2's float atomics make two eager runs
    differ already, so each field may differ from the first eager run by
    four times the two eager runs' largest difference, taken no smaller
    than the float32 spacing at the field's largest value: the atomics
    reach the exposures only through the parameters' rounding, and a
    field that two runs happen to leave equal moves by an ulp or two in a
    third. The segments capture once per camera count, and replay once
    per iteration but each segment's last."""
    _need_cuda()
    from splatslam_tpu_torch.mapping import gaussians as G
    from splatslam_tpu_torch.mapping import mapper as M
    from splatslam_tpu_torch.utils import profiling
    torch.backends.cuda.matmul.allow_tf32 = False
    eager = [_map_segments([torch.device("cuda")]) for _ in range(2)]
    M._SPLITS.clear()
    t = profiling.PhaseTimers("cuda")
    profiling.set_current(t)
    try:
        graphed = _map_segments(None)
        _map_segments(None)
    finally:
        profiling.set_current(None)
    assert t.total["n.map.capture"] == 2, t.total
    assert t.total["n.map.graphed"] == 2 * (7 + 7 + 3)
    fields = M._MAP_OUT + ("alive",)
    eps = torch.finfo(torch.float32).eps

    def row(name, e0, e1, g):
        if not e0.numel():
            return name, 0.0, 0.0
        spread = max(float((e0 - e1).abs().max()),
                     eps * float(e0.abs().max()))
        return name, float((g - e0).abs().max()), spread

    rows = [row(f, *(getattr(r[0], f).double() for r in (*eager, graphed)))
            for f in fields]
    rows += [row(f"exposure{i}", *(r[1][i].double()
                                   for r in (*eager, graphed)))
             for i in range(3)]
    print("\n".join(f"{f}: graphed-eager {gap:.3e}, eager-eager "
                    f"(or the spacing) {spread:.3e}"
                    for f, gap, spread in rows))
    for f, gap, spread in rows:
        assert gap <= 4 * spread, (f, gap, spread)
    moved = graphed[0].xyz - _map_state().xyz
    assert float(moved.abs().max()) > 1e-4


@pytest.mark.cuda
def test_graph_replays_do_not_synchronise():
    """With the sync debug mode counting (a profiler running), a graphed
    segment's iterations wait on the device nowhere."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile
    from splatslam_tpu_torch.utils import profiling
    _map_segments(None)         # every key captured
    t = profiling.PhaseTimers("cuda")
    profiling.set_current(t)
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            with t("map.opt"):
                _map_segments(None)
        with t("mapping"):      # the first phase edge after: counting off
            pass
    finally:
        profiling.set_current(None)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert t.total["n.map.graphed"] == 7 + 7 + 3
    assert "n.map.capture" not in t.total
    inside = {k: t.total.get(f"n.sync.{k}", 0)
              for k in ("map.iter", "map.fwd", "map.bwd", "map.adam")}
    assert not any(inside.values()), inside


@pytest.mark.cuda
def test_graphed_segments_keep_the_kernel_rooflines_readable():
    """B1 and B2 stay eager launches through ops/raster_cuda: the
    benchmark's launch records (probes.Counters) and the launches the
    device trace finds (trace.reduce) pair one to one, as b1_roofline and
    b2_roofline need."""
    _need_cuda()
    from benchmark import probes, trace
    _map_segments(None)
    counters = probes.Counters(MAP_H, MAP_W, MAP_K)
    patches = probes.Patches()
    counters.install(patches)
    try:
        counters.active = True
        prof = trace.start("cuda")
        _map_segments(None)
        torch.cuda.synchronize()
        trace.stop(prof)
    finally:
        patches.remove()
    red = trace.reduce(prof)
    _, launches = counters.read()
    for name in ("composite_fwd", "composite_bwd"):
        records = [x for x in launches if x[0] == name]
        assert len(records) == 20
        assert len(red["launches"][name]) == len(records), name


# -- DSPO stage 2's kernels (csrc/dspo.cu) -----------------------------------

def _dspo_to(p, dev, dtype=None):
    """A dspo_cases problem on `dev`, its float tensors in `dtype` if
    given, its edge set rebuilt there."""
    from splatslam_tpu_torch.ops import ba
    e = p["edges"]
    out = {k: (v.to(dev) if v.dtype == torch.bool or dtype is None
               else v.to(dev, dtype)) if torch.is_tensor(v) else v
           for k, v in p.items() if k != "edges"}
    out["edges"] = ba.make_edges(e.ii, e.jj, e.t0, e.t1, dev)
    return out


def _dspo_args(p):
    return [p[k] for k in ("poses", "disps", "intrinsics", "target",
                           "weight", "eta", "mono_disps", "scales", "shifts",
                           "valid_depth_mask", "edges", "lm", "ep", "alpha")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["replica", "loop", "hard", "singular",
                                  "nonfinite"])
def test_scale_shift_kernel_matches_plain(name):
    """One stage-2 iteration through the kernel against the plain version
    on the card and a float64 run of it: the same frames rejected, the rows
    outside kx copied, and every output within the float32 plain
    version's own distance from the float64 run (twice it, plus 1e-6)."""
    _need_cuda()
    from dspo_cases import make_problem
    from splatslam_tpu_torch.ops import ba, dspo_cuda
    p = _dspo_to(make_problem(name), "cuda")
    p64 = _dspo_to(make_problem(name), "cuda", torch.float64)
    dspo_cuda.reset_launch_counts()
    got = ba._scale_shift_iteration(*_dspo_args(p), kx_mask=p["kx_mask"])
    assert dspo_cuda.launches == {"scale_shift_iteration": 1,
                                  "depth_filter": 0}
    plain = ba._scale_shift_iteration_torch(*_dspo_args(p),
                                            kx_mask=p["kx_mask"])
    exact = ba._scale_shift_iteration_torch(*_dspo_args(p64),
                                            kx_mask=p64["kx_mask"])
    kx = p["edges"].kx
    out = torch.ones(p["disps"].shape[0], dtype=torch.bool, device="cuda")
    out[kx] = False
    ins = (p["disps"], p["scales"], p["shifts"])
    moved = [o[kx] != i[kx] for o, i in zip((got[1], plain[1]), ins[1:2] * 2)]
    assert torch.equal(*moved) and bool(moved[0].any())
    for label, g, q, x, i in zip(("disps", "scales", "shifts"), got, plain,
                                 exact, ins):
        assert torch.equal(g[out], i[out]), label
        e_k = float((g.double() - x).abs().max())
        e_p = float((q.double() - x).abs().max())
        print(f"{name} {label}: kernel-plain "
              f"{float((g - q).abs().max()):.3e}, kernel-f64 {e_k:.3e}, "
              f"plain-f64 {e_p:.3e}")
        assert e_k <= 2 * e_p + 1e-6, (label, e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eighth", "full"])
def test_depth_filter_kernel_matches_plain(name):
    """The multiview count through the kernel against the plain version
    on the card, at 1/8 and at full resolution, frames at the buffer's
    ends among them (neighbours outside it) and reprojections that leave
    the image."""
    _need_cuda()
    from dspo_cases import make_filter_problem
    from splatslam_tpu_torch.ops import dspo_cuda
    from splatslam_tpu_torch.tracking import depth_video as dv
    f = {k: v.cuda() for k, v in make_filter_problem(name).items()}
    args = (f["poses"], f["disps"], f["intrinsics"], f["inds"], f["thresh"])
    dspo_cuda.reset_launch_counts()
    got = dv.depth_filter(*args)
    assert dspo_cuda.launches == {"scale_shift_iteration": 0,
                                  "depth_filter": 1}
    plain = dv.depth_filter_torch(*args)
    diff = (got - plain).abs()
    print(f"{name}: {int((diff > 0).sum())} of {diff.numel()} counts "
          f"differ, by at most {float(diff.max()):g}")
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_update_rounds_gpu_matches_cpu():
    """One update_rounds call of the learned tracker (float32, TF32 off)
    with two stage-1 and two stage-2 rounds, the bad-mono test on, on the
    card (stage 2 through the kernels) against the CPU (plain versions):
    the network parity tolerance (atol 2e-4 / rtol 1e-3) carried through
    four rounds."""
    _need_cuda()
    from splatslam_tpu_torch.ops import dspo_cuda, lie
    from splatslam_tpu_torch.tracking.factor_graph import FactorGraph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs, launched = {}, {}
    for dev in ("cpu", "cuda"):
        ds, model, video, mf, frames, intr = _tracker(dev, -1.0)
        for k in range(1, 8):
            assert mf.track(float(k), frames[k], intr)
        s = video.state
        # GT poses and disparities: both stage-2 rounds run, one of their
        # depth frames bad-mono (the multiview threshold of tests/tiny.py)
        for k in range(8):
            s.poses[k] = torch.as_tensor(lie.from_matrix_np(
                np.linalg.inv(ds[k][3]) @ ds[0][3]), device=dev)
            s.disps[k] = torch.as_tensor(
                1.0 / np.maximum(ds[k][2][3::8, 3::8][:8, :12], 1e-6),
                device=dev)
        video.mono_thres = 0.5
        video.cfg["tracking"]["multiview_filter"]["thresh"] = 1.0
        g = FactorGraph(video, model, max_factors=48)
        g.add_neighborhood_factors(0, 8, r=2)
        dspo_cuda.reset_launch_counts()
        g.update_rounds(("pose_depth", "depth_scale") * 2, t0=2,
                        use_inactive=True)
        launched[dev] = dict(dspo_cuda.launches)
        outs[dev] = (s.poses[:8], s.disps[:8], s.depth_scale[:8],
                     s.depth_shift[:8])
    assert launched["cpu"] == {"scale_shift_iteration": 0, "depth_filter": 0}
    assert launched["cuda"] == {"scale_shift_iteration": 4,
                                "depth_filter": 2}
    for name, c, k in zip(("poses", "disps", "scales", "shifts"),
                          outs["cpu"], outs["cuda"]):
        print(f"{name}: max|cuda-cpu| {float((k.cpu() - c).abs().max()):.3e}")
        torch.testing.assert_close(k.cpu(), c, atol=2e-4, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")
