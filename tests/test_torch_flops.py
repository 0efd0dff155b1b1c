"""The achieved-FLOP counters (DepthVideo.flops_tracking / flops_mapping)
against the JAX package's, producer by producer: the same call in both
packages adds the same amount (rtol 1e-12), at sizes where the JAX
package's geometric buckets pad nothing (32 edge pairs for a distance,
a 32-edge active pool beside a 32-edge inactive block for the update
rounds, 4 mapping cameras).

The counters are host arithmetic over sizes and branches. Where the JAX
side's device program is a large compile that decides neither (the
tracker network in the motion filter, the learned fused update rounds),
that program is replaced in the JAX module by a stand-in of the right
shapes, so the test holds the JAX producer's own counting code; the
port's side always runs for real (a small random network, 48x64). The
frame distance, the oracle update rounds, a mapping segment and the
keyframe fusion and gate run for real in both packages. The whole-run
check (the port's totals against the JAX run's on the shrunk SLAM
configurations) is in tests/test_torch_slam.py, beside the runs it reads.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.mapping import camera as jcam
from splatslam_tpu.mapping import mapper as jM
from splatslam_tpu.ops import lie as jlie
from splatslam_tpu.tracking import depth_video as jdv
from splatslam_tpu.tracking import factor_graph as jfg
from splatslam_tpu.tracking import motion_filter as jmf
from splatslam_tpu_torch.config import load_config
from splatslam_tpu_torch.convert import (gaussian_state_from_numpy,
                                         video_state_from_numpy)
from splatslam_tpu_torch.mapping import camera as tcam
from splatslam_tpu_torch.mapping import mapper as tM
from splatslam_tpu_torch.models.droid_net import DroidNet
from splatslam_tpu_torch.tracking import depth_video as tdv
from splatslam_tpu_torch.tracking import factor_graph as tfg
from splatslam_tpu_torch.tracking import motion_filter as tmf
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, BUF = 48, 64, 16
h, w = H // 8, W // 8
INTR = np.asarray([50.0, 50.0, 31.5, 23.5], np.float32)
RTOL = 1e-12


def _cfg(oracle=True, thresh=1.0):
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    cfg["cam"].update(H=H, W=W, H_out=H, W_out=W, fx=50.0, fy=50.0,
                      cx=31.5, cy=23.5)
    tr = cfg["tracking"]
    tr.update(oracle=oracle, buffer=BUF, mono_thres=False)
    tr["motion_filter"]["thresh"] = thresh
    tr["backend"]["BA_type"] = "DSPO"
    cfg["mapping"].update(capacity=512, raster_K=32)
    return cfg


def _videos(cfg, n=10, seed=0):
    """Both packages' DepthVideo on one state: n keyframes of small random
    motion, disparities around 0.5, the intrinsics set."""
    vj = jdv.DepthVideo(cfg)
    rng = np.random.RandomState(seed)
    st = vj.state
    poses = np.asarray(st.poses).copy()
    poses[:n] = np.asarray(jlie.exp(jnp.asarray(
        np.cumsum(rng.randn(n, 6) * 0.02, 0).astype(np.float32))))
    disps = np.asarray(st.disps).copy()
    disps[:n] = 0.4 + 0.2 * rng.rand(n, h, w)
    upd = dict(poses=poses, disps=disps, gt_poses=poses, gt_disps=disps,
               intrinsics=np.tile(INTR / 8.0, (BUF, 1)))
    vj.state = dataclasses.replace(st, **{k: jnp.asarray(v, getattr(
        st, k).dtype) for k, v in upd.items()})
    vj.counter = n
    vt = tdv.DepthVideo(cfg, device="cpu")
    vt.state = video_state_from_numpy(
        {f: np.asarray(getattr(vj.state, f))
         for f in vj.state.__dataclass_fields__}, device="cpu")
    vt.counter = n
    return vj, vt


def _close(got, want):
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["directed", "bidirectional"])
def test_distance_flops_match_jax(bidirectional):
    vj, vt = _videos(_cfg())
    rng = np.random.RandomState(1)
    ii, jj = rng.randint(0, 10, 32), rng.randint(0, 10, 32)
    dj = vj.distance(ii, jj, bidirectional=bidirectional)
    dt = vt.distance(ii, jj, bidirectional=bidirectional)
    np.testing.assert_allclose(dt, dj, rtol=1e-4)
    _close(vt.flops_tracking, vj.flops_tracking)
    assert vt.flops_mapping == vj.flops_mapping == 0.0


def _stub_jax_network(monkeypatch):
    """The JAX motion filter's network programs as zero stand-ins of the
    right shapes (flow magnitude 0)."""
    z = lambda *s, dt=jnp.float32: jnp.zeros(s, dt)
    monkeypatch.setattr(jmf, "encode_features",
                        lambda p, img: z(h, w, 128, dt=jnp.bfloat16))
    monkeypatch.setattr(jmf, "encode_context",
                        lambda p, img: (z(h, w, 128), z(h, w, 128)))
    monkeypatch.setattr(jmf, "track_kernel",
                        lambda p, img, *a: (z(h, w, 128, dt=jnp.bfloat16),
                                            jnp.float32(0.0)))

    def scan(p, imgs, *a):
        C = imgs.shape[0]
        return (z(2 * C), z(C, h, w, 128, dt=jnp.bfloat16), z(C, h, w, 128),
                z(C, h, w, 128))
    monkeypatch.setattr(jmf, "admission_scan", scan)


def _frames(n, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, H, W, 3) * 255).astype(np.uint8)


def test_motion_filter_learned_flops_match_jax(monkeypatch):
    """Per frame: the first frame (features), admitted frames (track
    kernel, context) at thresh -1, rejected frames (track kernel) at thresh
    1e9; then the chunked scan over 3 frames."""
    _stub_jax_network(monkeypatch)
    cfg = _cfg(oracle=False, thresh=-1.0)
    vj, vt = (jdv.DepthVideo(cfg), tdv.DepthVideo(cfg, device="cpu"))
    mj = jmf.MotionFilter(None, vj, cfg)
    mt = tmf.MotionFilter(DroidNet(device="cpu",
                                   generator=torch.Generator().manual_seed(0)),
                          vt, cfg)
    imgs = _frames(8)
    for k in range(6):
        if k == 4:
            mj.thresh = mt.thresh = 1e9
        aj = mj.track(float(k), jnp.asarray(imgs[k]), INTR)
        at = mt.track(float(k), imgs[k], INTR)
        assert aj == at == (k < 4)
        _close(vt.flops_tracking, vj.flops_tracking)
    mj.decide_batch(jnp.asarray(imgs[5:8]), 3)
    mt.decide_batch(torch.as_tensor(imgs[5:8]), 3)
    _close(vt.flops_tracking, vj.flops_tracking)
    assert vt.counter == vj.counter == 4


def test_motion_filter_oracle_flops_match_jax(monkeypatch):
    """Oracle admission: the first frame, a frame that moves past the
    threshold (features and context), one that does not (nothing), and
    one without a GT pose (features, then admitted)."""
    _stub_jax_network(monkeypatch)
    cfg = _cfg(oracle=True, thresh=1.0)
    vj, vt = (jdv.DepthVideo(cfg), tdv.DepthVideo(cfg, device="cpu"))
    mj = jmf.MotionFilter(None, vj, cfg)
    mt = tmf.MotionFilter(DroidNet(device="cpu",
                                   generator=torch.Generator().manual_seed(0)),
                          vt, cfg)
    imgs = _frames(4)
    depth = np.full((H, W), 2.0, np.float32)
    poses = [np.asarray([0, 0, 0, 0, 0, 0, 1.0]),
             np.asarray([0.6, 0, 0, 0, 0, 0, 1.0]),
             np.asarray([0.6, 0, 0, 0, 0, 0, 1.0]), None]
    admitted = []
    for k, pose in enumerate(poses):
        kw = {} if pose is None else dict(gt_pose=pose, gt_depth=depth)
        aj = mj.track(float(k), jnp.asarray(imgs[k]), INTR, **kw)
        at = mt.track(float(k), imgs[k], INTR, **kw)
        assert aj == at
        admitted.append(at)
        _close(vt.flops_tracking, vj.flops_tracking)
    assert admitted == [True, True, False, True]


def _graphs(oracle, monkeypatch):
    """Both packages' FactorGraph over the same video with 32 inactive
    edges (added, then removed with store) and 32 active ones."""
    cfg = _cfg(oracle=oracle)
    vj, vt = _videos(cfg)
    if oracle:
        gj = jfg.FactorGraph(vj, None, oracle=True)
        gt = tfg.FactorGraph(vt, None, oracle=True)
    else:
        # the JAX learned round program as a stand-in that returns the
        # state it was given
        def fused(params, poses, disps, disps_up, intr, fmaps, inps, mono,
                  dscale, dshift, valid_small, gt_poses, gt_disps, net,
                  target, weight, target_in, weight_in, ii, jj, ev, iv, ix,
                  uniq, plan, damping, *a, **k):
            return (poses, disps, disps_up, net, target, weight, damping,
                    dscale, dshift, valid_small, jnp.float32(0.0))
        monkeypatch.setattr(jfg, "_fused_rounds", fused)
        gj = jfg.FactorGraph(vj, None, oracle=False)
        gt = tfg.FactorGraph(vt, DroidNet(
            device="cpu", generator=torch.Generator().manual_seed(0)),
            oracle=False)
    pairs = [(i, j) for i in range(10) for j in range(10) if i != j]
    rng = np.random.RandomState(3)
    pick = rng.permutation(len(pairs))[:64]
    e = np.asarray([pairs[p] for p in pick])
    for g in (gj, gt):
        g.add_factors(e[:32, 0], e[:32, 1])
        g.rm_factors(np.ones(32, bool), store=True)
        g.add_factors(e[32:, 0], e[32:, 1])
        assert len(g.ii) == len(g.ii_inac) == 32
    return vj, vt, gj, gt


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "learned"])
def test_update_rounds_flops_match_jax(oracle, monkeypatch):
    vj, vt, gj, gt = _graphs(oracle, monkeypatch)
    before_j, before_t = vj.flops_tracking, vt.flops_tracking
    assert before_t == before_j
    opt = ("pose_depth", "pose_depth", "pose_depth")
    gj.update_rounds(opt, t0=1, use_inactive=True)
    gt.update_rounds(opt, t0=1, use_inactive=True)
    assert vt.flops_tracking > before_t
    _close(vt.flops_tracking, vj.flops_tracking)
    coeff = 2e3 if oracle else 2.8e6
    np.testing.assert_allclose(vt.flops_tracking - before_t,
                               3 * (coeff + 3e3) * 64 * h * w, rtol=RTOL)


class _Data:
    def __init__(self, n=2, seed=4):
        rng = np.random.RandomState(seed)
        self.frames = [(k, rng.rand(H, W, 3).astype(np.float32),
                        np.full((H, W), 2.0, np.float32), np.eye(4))
                       for k in range(n)]

    def get_intrinsic(self):
        return INTR

    def __getitem__(self, k):
        return self.frames[k]


def _mappers(use_ssim):
    cfg = _cfg()
    cfg["mapping"]["Training"]["ssim_loss"] = use_ssim
    vj, vt = _videos(cfg)
    data = _Data()
    mj = jM.Mapper(cfg, vj, data)
    mt = tM.Mapper(cfg, vt, data, device="cpu")
    rng = np.random.RandomState(5)
    C = mj.st.xyz.shape[0]
    upd = dict(xyz=np.stack([rng.uniform(-0.8, 0.8, C),
                             rng.uniform(-0.6, 0.6, C),
                             1.5 + 1.5 * rng.permutation(C) / C], -1),
               f_dc=rng.randn(C, 3) * 0.5,
               opacity=rng.uniform(-1.0, 2.0, (C, 1)),
               scaling=np.log(rng.uniform(0.02, 0.12, (C, 3))),
               rotation=rng.randn(C, 4), alive=np.arange(C) < 400)
    mj.st = dataclasses.replace(mj.st, **{k: jnp.asarray(v, getattr(
        mj.st, k).dtype) for k, v in upd.items()})
    mt.st = gaussian_state_from_numpy(
        {f.name: np.asarray(getattr(mj.st, f.name))
         for f in dataclasses.fields(mj.st)}, device="cpu")
    return vj, vt, mj, mt, data


@pytest.mark.parametrize("use_ssim", [False, True], ids=["l1", "ssim"])
def test_mapping_segment_flops_match_jax(use_ssim):
    """One _run_iters call over 4 cameras (one iteration: Σ n_touched of
    the last iteration is the same in both packages)."""
    vj, vt, mj, mt, data = _mappers(use_ssim)
    rng = np.random.RandomState(6)
    cams_j, cams_t = [], []
    for uid in range(4):
        w2c = np.eye(4)
        w2c[:3, 3] = 0.03 * rng.randn(3)
        img = rng.rand(H, W, 3).astype(np.float32)
        dep = (2.0 + 0.3 * rng.rand(H, W)).astype(np.float32)
        cams_j.append(jcam.make_camera(uid, img, dep, w2c))
        cams_t.append(tcam.make_camera(uid, img, dep, w2c, device="cpu"))
    mj._run_iters(cams_j, 1)
    mj._drain_pack()
    mt._run_iters(cams_t, 1)
    _close(vt.flops_mapping, vj.flops_mapping)
    assert vt.flops_tracking == vj.flops_tracking == 0.0


def test_keyframe_fusion_flops_match_jax():
    """process_keyframe's fusion and gate render (no mono prior: both
    packages count it and then refuse the keyframe)."""
    vj, vt, mj, mt, data = _mappers(False)
    assert mj.process_keyframe(1, 3) is False
    assert mt.process_keyframe(1, 3) is False
    _close(vt.flops_mapping, vj.flops_mapping)
    cap = mt.st.capacity
    np.testing.assert_allclose(
        vt.flops_mapping, H * W * (500.0 + 0.25 * 32 * 110.0) + cap * 500.0,
        rtol=RTOL)
