"""Learned-tracker parity: the PyTorch port's update operator, learned and
motion-only update rounds and keyframe admission against the JAX package's,
both in float32 on the CPU with the in-repo checkpoint.

The scene is the first frames of the Synthetic dataset at 64×104 (1/8 size
8×13, an odd width), buffer 24 — shapes no other test file traces, so the
float32 JAX programs compiled here (SPLATSLAM_F32_NET is read when a
function is traced) are never handed to, or taken from, another file's
cache.

Tolerances: one operator call atol 2e-4 / rtol 1e-3; poses and disparities
after 8 learned or 12 motion-only rounds atol 2e-4 (measured: 2e-6 and 1e-5;
each round feeds a float32 Gauss-Newton solve back into the network);
admission deltas 5e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu_torch import convert
from splatslam_tpu_torch.models import weights as tweights
from splatslam_tpu_torch.models.droid_net import DroidNet
from splatslam_tpu_torch.ops import lie as tlie
from splatslam_tpu_torch.tracking import depth_video as tdv
from splatslam_tpu_torch.tracking import factor_graph as tfg
from splatslam_tpu_torch.tracking import motion_filter as tmf

import os
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "pretrained/droid_dba.msgpack")
H, W, BUF = 64, 104, 24
TOL = dict(atol=2e-4, rtol=1e-3)


def _cfg(thresh=-1.0):
    return {
        "dataset": "synthetic",
        "synthetic": {"n_frames": 24, "seed": 7, "motion_scale": 5.0},
        "cam": {"H": H, "W": W, "fx": 65.0, "fy": 65.0, "cx": 51.5,
                "cy": 31.5, "H_edge": 0, "W_edge": 0, "H_out": H, "W_out": W},
        "tracking": {
            "oracle": False, "buffer": BUF, "beta": 0.6, "warmup": 5,
            "max_age": 25, "mono_thres": False,
            "motion_filter": {"thresh": thresh},
            "multiview_filter": {"thresh": 0.01, "visible_num": 2},
            "frontend": {"enable_loop": False, "enable_online_ba": False,
                         "keyframe_thresh": 0.1, "thresh": 1e9, "window": 8,
                         "radius": 2, "nms": 1, "max_factors": 48},
            "backend": {"final_ba": True, "ba_freq": 8, "thresh": 1e9,
                        "radius": 1, "nms": 2, "loop_window": 8,
                        "loop_thresh": 1e9, "loop_radius": 1, "loop_nms": 2,
                        "BA_type": "DSPO", "normalize": False},
        },
    }


@pytest.fixture(scope="module", autouse=True)
def _float32_network():
    """Both packages read SPLATSLAM_F32_NET; the JAX one when it traces."""
    old = os.environ.get("SPLATSLAM_F32_NET")
    os.environ["SPLATSLAM_F32_NET"] = "1"
    yield
    if old is None:
        os.environ.pop("SPLATSLAM_F32_NET", None)
    else:
        os.environ["SPLATSLAM_F32_NET"] = old


@pytest.fixture(scope="module")
def world(_float32_network):
    """The dataset, both packages' networks, and a JAX video of 6 learned
    keyframes (frames 0,2,..,10 with the GT depth as mono prior)."""
    from splatslam_tpu.datasets import Synthetic
    from splatslam_tpu.models import load_droid_params
    from splatslam_tpu import tracking as jtr
    cfg = _cfg()
    ds = Synthetic(cfg)
    params = load_droid_params(CKPT)
    model = tweights.load_droid_params(CKPT, device="cpu")
    assert model.dtype == torch.float32
    video = jtr.DepthVideo(cfg)
    mf = jtr.MotionFilter(params, video, cfg,
                          mono_fn=lambda t, img: ds[int(t)][2])
    intr = np.asarray(ds.get_intrinsic())
    for k in range(0, 12, 2):
        assert mf.track(float(k), jnp.asarray(ds[k][1]), intr)
    # a start the rounds have work on but that is well conditioned: the GT
    # poses (relative to frame 0) and GT disparities, each perturbed. (From
    # a start far off, a multiview-mask bit that flips on a float32 tie
    # changes a frame's scale fit and the two runs part for good.)
    from splatslam_tpu.ops import lie as jlie
    rng = np.random.RandomState(0)
    s = video.state
    poses = np.asarray(s.poses).copy()
    disps = np.asarray(s.disps).copy()
    for k in range(6):
        poses[k] = jlie.from_matrix_np(
            np.linalg.inv(ds[2 * k][3]) @ ds[0][3])
        disps[k] = 1.0 / np.maximum(
            ds[2 * k][2][3::8, 3::8][:H // 8, :W // 8], 1e-6)
    xi = np.zeros((BUF, 6), np.float32)
    xi[1:6] = rng.randn(5, 6) * [.01, .01, .01, .002, .002, .002]
    s.poses = jlie.mul(jlie.exp(jnp.asarray(xi)), jnp.asarray(poses))
    disps[:6] *= (1 + 0.05 * rng.randn(6, H // 8, W // 8)).astype(np.float32)
    s.disps = jnp.asarray(disps)
    video.pose_gen += 1
    return dict(cfg=cfg, ds=ds, params=params, model=model, video=video,
                snap=dataclasses.replace(video.state))


def _state_np(st):
    return {f: np.asarray(getattr(st, f)) for f in st.__dataclass_fields__}


def _port_video(world):
    v = tdv.DepthVideo(world["cfg"], device="cpu")
    v.state = convert.video_state_from_numpy(_state_np(world["snap"]),
                                             device="cpu")
    v.counter = 6
    return v


def _jax_graph(world, **kw):
    from splatslam_tpu.tracking import FactorGraph
    video = world["video"]
    video.state = dataclasses.replace(world["snap"])
    video.counter = 6
    video._intr0 = None
    video.pose_gen += 1
    return FactorGraph(video, world["params"], **kw)


def _mats(p):
    return tlie.to_matrix(torch.as_tensor(np.array(p))).numpy()


def _cl(x):
    return np.moveaxis(x.numpy(), 1, -1)


def test_carried_state_holds_the_network_fields(world):
    v = _port_video(world)
    s, j = v.state, world["snap"]
    assert s.fmaps.dtype == torch.bfloat16 and s.fmaps.shape == (BUF, 128, 8,
                                                                 13)
    np.testing.assert_array_equal(
        _cl(s.fmaps.float())[:6], np.asarray(j.fmaps[:6].astype(jnp.float32)))
    np.testing.assert_array_equal(_cl(s.nets)[:6], np.asarray(j.nets[:6]))
    np.testing.assert_array_equal(_cl(s.inps)[:6], np.asarray(j.inps[:6]))
    assert float(s.nets[:6].abs().sum()) > 0


def test_update_operator_matches_jax(world):
    from splatslam_tpu.tracking import factor_graph as jfg
    g = _jax_graph(world, max_factors=48)
    g.add_neighborhood_factors(0, 6, r=2)
    n = len(g.ii)
    ii_p, jj_p, valid, ix, uniq, Mk = g._padded_edges()
    s = g.video.state
    net_j, tgt_j, wgt_j, eta_j, up_j, c1_j, _ = jfg._update_kernel(
        g.params, s.poses, s.disps, g.video.intr0, s.fmaps, s.inps, g.net,
        g.target, jnp.asarray(ii_p, jnp.int32), jnp.asarray(jj_p, jnp.int32),
        jnp.asarray(valid), jnp.asarray(ix, jnp.int32), Mk)

    v = _port_video(world)
    tg = tfg.FactorGraph(v, world["model"], max_factors=48)
    tg.add_neighborhood_factors(0, 6, r=2)
    np.testing.assert_array_equal(tg.ii, g.ii)
    np.testing.assert_array_equal(tg.jj, g.jj)
    np.testing.assert_array_equal(_cl(tg.net), np.asarray(g.net[:n]))
    ts = v.state
    net_t, tgt_t, wgt_t, eta_t, up_t, uniq_t, c1_t = tfg.update_operator(
        world["model"], ts.poses, ts.disps, v.intr0, ts.fmaps, ts.inps,
        tg.net, tg.target, tg._idx(tg.ii), tg._idx(tg.jj))
    np.testing.assert_array_equal(uniq_t.numpy(), uniq)
    np.testing.assert_allclose(c1_t.numpy(), np.asarray(c1_j[:n]), rtol=1e-5,
                               atol=1e-4)
    m = len(uniq)
    for name, got, want in (
            ("net", _cl(net_t), net_j[:n]), ("target", tgt_t.numpy(),
                                             tgt_j[:n]),
            ("weight", wgt_t.numpy(), wgt_j[:n]),
            ("eta", eta_t.numpy(), eta_j[:m]),
            ("upmask", _cl(up_t), up_j[:m])):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **TOL)
    # the flow revision is real work, not a pass-through of the reprojection
    assert float((tgt_t - c1_t).abs().max()) > 1e-2
    assert tgt_t.dtype == wgt_t.dtype == eta_t.dtype == torch.float32
    # chunking the correlation by bytes changes nothing
    old = tfg.CORR_CHUNK_BYTES
    try:
        tfg.CORR_CHUNK_BYTES = 4 * (8 * 13) ** 2 * 3     # 3 edges per call
        assert tfg.corr_chunk(8, 13) == 3
        again = tfg.update_operator(
            world["model"], ts.poses, ts.disps, v.intr0, ts.fmaps, ts.inps,
            tg.net, tg.target, tg._idx(tg.ii), tg._idx(tg.jj))
    finally:
        tfg.CORR_CHUNK_BYTES = old
    np.testing.assert_allclose(again[1].numpy(), tgt_t.numpy(), atol=1e-5)


ROUNDS = ("pose_depth", "depth_scale") * 4


def test_learned_update_rounds_match_jax(world):
    """8 learned rounds (DSPO stages alternating) on a 6-keyframe graph,
    then the cull distance and the convex upsampling with the last mask."""
    g = _jax_graph(world, max_factors=48)
    g.add_neighborhood_factors(0, 6, r=3)
    d_j = float(g.update_rounds(ROUNDS, t0=1, use_inactive=True,
                                cull_pair=(4, 5), cull_beta=0.6))
    sj = g.video.state

    v = _port_video(world)
    tg = tfg.FactorGraph(v, world["model"], max_factors=48)
    tg.add_neighborhood_factors(0, 6, r=3)
    p0 = v.state.poses.clone()
    d_t = tg.update_rounds(ROUNDS, t0=1, use_inactive=True, cull_pair=(4, 5),
                           cull_beta=0.6)
    st = v.state
    assert float((st.poses[1:6] - p0[1:6]).abs().max()) > 1e-3   # they moved
    np.testing.assert_array_equal(st.poses[0].numpy(), p0[0].numpy())
    np.testing.assert_allclose(_mats(st.poses[:6]), _mats(sj.poses[:6]),
                               atol=2e-4)
    np.testing.assert_allclose(st.disps[:6].numpy(), np.asarray(sj.disps[:6]),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(
        st.valid_depth_mask_small[:6].numpy(),
        np.asarray(sj.valid_depth_mask_small[:6]))
    np.testing.assert_allclose(st.disps_up[:6].numpy(),
                               np.asarray(sj.disps_up[:6]), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(st.depth_scale[:6].numpy(),
                               np.asarray(sj.depth_scale[:6]), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(d_t, d_j, atol=1e-3, rtol=1e-3)
    n = len(tg.ii)
    np.testing.assert_allclose(tg.weight.numpy(), np.asarray(g.weight[:n]),
                               atol=2e-3)
    np.testing.assert_allclose(tg.damping_maps[:6].numpy(),
                               np.asarray(g.damping_maps[:6]), atol=1e-4,
                               rtol=1e-2)
    assert (tg.age == 8).all()


def test_motion_only_rounds_match_jax(world):
    """12 motion-only rounds as the trajectory filler runs them: frames 4
    and 5 move against keyframes 2 and 3, everything else is frozen."""
    def edges(g):
        g.add_factors(np.asarray([2, 2]), np.asarray([4, 5]))
        g.add_factors(np.asarray([3, 3]), np.asarray([4, 5]))

    g = _jax_graph(world, upsample=False)
    edges(g)
    g.update_rounds_motion_only(12, 4, 6)
    pj = np.asarray(g.video.state.poses[:6])

    v = _port_video(world)
    p0 = v.state.poses.clone()
    d0 = v.state.disps.clone()
    tg = tfg.FactorGraph(v, world["model"], upsample=False)
    edges(tg)
    tg.update_lowmem(t0=4, t1=6, steps=12, motion_only=True)
    pt = v.state.poses
    np.testing.assert_array_equal(pt[:4].numpy(), p0[:4].numpy())
    np.testing.assert_array_equal(v.state.disps.numpy(), d0.numpy())
    assert float((pt[4:6] - p0[4:6]).abs().max()) > 1e-4
    np.testing.assert_allclose(_mats(pt[:6]), _mats(pj), atol=2e-4)
    assert (tg.age == 12).all()


def test_single_update_and_edge_bookkeeping(world):
    """update() through DepthVideo.ba against the JAX one; then net rows
    follow their edges through rm_factors, filter_edges and rm_keyframe."""
    g = _jax_graph(world, max_factors=48)
    g.add_neighborhood_factors(0, 6, r=2)
    g.update(1, opt_type="pose_depth")
    v = _port_video(world)
    tg = tfg.FactorGraph(v, world["model"], max_factors=48)
    tg.add_neighborhood_factors(0, 6, r=2)
    tg.update(1, opt_type="pose_depth")
    np.testing.assert_allclose(_mats(v.state.poses[:6]),
                               _mats(g.video.state.poses[:6]), atol=1e-4)
    np.testing.assert_allclose(v.state.disps_up[:6].numpy(),
                               np.asarray(g.video.state.disps_up[:6]),
                               atol=1e-3, rtol=1e-3)

    n = len(tg.ii)
    tag = tg.net[:, 0, 0, 0].clone()
    drop = tg.ii == 5
    tg.rm_factors(drop, store=True)
    assert tg.net.shape[0] == n - drop.sum() == len(tg.ii)
    np.testing.assert_array_equal(tg.net[:, 0, 0, 0].numpy(),
                                  tag.numpy()[~drop])
    assert len(tg.ii_inac) == drop.sum()
    tg.weight[0] = 0.0                      # a dead long edge is filtered
    tg.ii[0], tg.jj[0] = 0, 3
    tg.filter_edges()
    assert (tg.ii_bad, tg.jj_bad) == (np.asarray([0]), np.asarray([3]))
    before = v.state.nets[3].clone()
    tg.rm_keyframe(2)
    assert torch.equal(v.state.nets[2], before)
    assert tg.net.shape[0] == len(tg.ii) and (tg.ii != 5).all()


# -- admission ---------------------------------------------------------------

def _frames_u8(ds, n):
    return np.stack([(np.asarray(ds[k][1]) * 255.0).astype(np.uint8)
                     for k in range(n)])


@pytest.mark.parametrize("thresh,admits_all", [(-1.0, True), (1e6, False)],
                         ids=["all_admitted", "none_admitted"])
def test_chunked_admission_matches_per_frame_chain(world, thresh, admits_all):
    """admission_scan against the per-frame chain inside the port, on both
    branches of the carry (tests/test_tracking.py's construction)."""
    model, ds = world["model"], world["ds"]
    intr = np.asarray(ds.get_intrinsic())
    frames = _frames_u8(ds, 9)
    cfg = _cfg(thresh)

    va = tdv.DepthVideo(cfg, device="cpu")
    mfa = tmf.MotionFilter(model, va, cfg)
    ref = []
    for k in range(9):
        admitted = mfa.track(float(k), frames[k], intr)
        if k:
            ref.append(admitted)
    assert all(a == admits_all for a in ref)

    vb = tdv.DepthVideo(cfg, device="cpu")
    mfb = tmf.MotionFilter(model, vb, cfg)
    mfb.track(0.0, frames[0], intr)
    # the chain's deltas, frame by frame, for the comparison below
    fmap, net, inp = mfb.fmap, mfb.net, mfb.inp
    ref_d = []
    for k in range(1, 9):
        gmap, d = tmf.track_kernel(model, frames[k], fmap, net, inp)
        ref_d.append(float(d))
        if ref_d[-1] > thresh:
            fmap = gmap
            net, inp = tmf.encode_context(model, frames[k])
    got_d, got_a = [], []
    for c0 in (1, 5):
        imgs = torch.as_tensor(frames[c0:c0 + 4])
        batch = mfb.decide_batch(imgs, 4)
        for k in range(4):
            got_d.append(float(batch[1][k]))
            got_a.append(bool(batch[0][k]))
            if batch[0][k]:
                mfb.commit_batch_frame(k, batch, float(c0 + k), imgs, intr)
            else:
                mfb.count += 1
    assert got_a == ref
    np.testing.assert_allclose(got_d, ref_d, atol=5e-3, rtol=5e-3)
    assert vb.counter == va.counter == (9 if admits_all else 1)
    assert mfb.count == mfa.count
    np.testing.assert_allclose(mfb.fmap.float().numpy(),
                               mfa.fmap.float().numpy(), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(mfb.net.numpy(), mfa.net.numpy(), atol=1e-2,
                               rtol=1e-2)
    n = vb.counter
    np.testing.assert_array_equal(vb.state.timestamp[:n].numpy(),
                                  va.state.timestamp[:n].numpy())
    np.testing.assert_allclose(vb.state.fmaps[:n].float().numpy(),
                               va.state.fmaps[:n].float().numpy(), atol=2e-2)


def test_admission_decisions_match_jax(world):
    """The same 16 frames through both packages' chunked admission at a
    threshold that splits them: equal decisions, deltas within 5e-3, and
    the port's per-frame chain decides the same."""
    from splatslam_tpu import tracking as jtr
    model, ds = world["model"], world["ds"]
    intr = np.asarray(ds.get_intrinsic())
    frames = _frames_u8(ds, 16)
    cfg = _cfg(0.5)

    jv = jtr.DepthVideo(cfg)
    jmf = jtr.MotionFilter(world["params"], jv, cfg)
    jmf.track(0.0, jnp.asarray(frames[0]), intr)
    tv = tdv.DepthVideo(cfg, device="cpu")
    tm = tmf.MotionFilter(model, tv, cfg)
    tm.track(0.0, frames[0], intr)
    dj, dt, aj, at = [], [], [], []
    for c0 in (1, 9):
        m = min(8, 16 - c0)
        chunk = frames[c0:c0 + m]
        pad = np.concatenate([chunk, np.repeat(chunk[-1:], 8 - m, 0)])
        jimgs = jnp.asarray(pad)
        jb = jmf.decide_batch(jimgs, m)
        timgs = torch.as_tensor(chunk)
        tb = tm.decide_batch(timgs, m)
        for k in range(m):
            dj.append(float(jb[1][k]))
            dt.append(float(tb[1][k]))
            aj.append(bool(jb[0][k]))
            at.append(bool(tb[0][k]))
            if jb[0][k]:
                jmf.commit_batch_frame(k, jb, float(c0 + k), jimgs, intr)
            if tb[0][k]:
                tm.commit_batch_frame(k, tb, float(c0 + k), timgs, intr)
    assert at == aj
    assert any(at) and not all(at), dt       # the threshold splits the frames
    np.testing.assert_allclose(dt, dj, atol=5e-3, rtol=5e-3)
    assert tv.counter == jv.counter
    np.testing.assert_array_equal(tv.state.timestamp[:tv.counter].numpy(),
                                  np.asarray(jv.state.timestamp[:jv.counter]))

    pv = tdv.DepthVideo(cfg, device="cpu")
    pm = tmf.MotionFilter(model, pv, cfg)
    per_frame = [pm.track(float(k), frames[k], intr) for k in range(16)]
    assert per_frame[1:] == at


def test_oracle_admission_stores_network_fields(world):
    """Oracle mode admits on GT flow but still encodes the admitted
    keyframe's maps: the trajectory filler reads them in every mode."""
    model, ds = world["model"], world["ds"]
    cfg = _cfg(0.2)
    cfg["tracking"]["oracle"] = True
    v = tdv.DepthVideo(cfg, device="cpu")
    mf = tmf.MotionFilter(model, v, cfg)
    intr = np.asarray(ds.get_intrinsic())
    for k in range(4):
        _, img, dep, c2w = ds[k]
        mf.track(float(k), img, intr,
                 gt_pose=tlie.from_matrix_np(np.linalg.inv(c2w)),
                 gt_depth=dep)
    n = v.counter
    assert n >= 2
    s = v.state
    for k in range(n):
        t = int(s.timestamp[k])
        want = tmf.encode_features(model, ds[t][1])
        np.testing.assert_array_equal(s.fmaps[k].float().numpy(),
                                      want.to(torch.bfloat16).float().numpy())
        assert float(s.nets[k].abs().sum()) > 0
        assert float(s.inps[k].abs().sum()) > 0


def test_bf16_network_stays_close_to_float32(world):
    """The hot path's dtype: a bf16 net's admission delta within 5 % of
    float32's on real frames, and the video keeps fmaps in bf16 (nets and
    inps in float32) whatever the network's dtype."""
    ds = world["ds"]
    m32 = world["model"]
    m16 = tweights.load_droid_params(CKPT, device="cpu", dtype=torch.bfloat16)
    assert m16.dtype == torch.bfloat16
    cfg = _cfg()
    deltas = {}
    for name, model in (("f32", m32), ("bf16", m16)):
        v = tdv.DepthVideo(cfg, device="cpu")
        mf = tmf.MotionFilter(model, v, cfg)
        intr = np.asarray(ds.get_intrinsic())
        mf.track(0.0, _frames_u8(ds, 1)[0], intr)
        assert v.state.fmaps.dtype == torch.bfloat16
        assert v.state.nets.dtype == v.state.inps.dtype == torch.float32
        assert mf.fmap.dtype == model.dtype
        _, d = tmf.track_kernel(model, _frames_u8(ds, 4)[3], mf.fmap, mf.net,
                                mf.inp)
        deltas[name] = float(d)
    assert deltas["f32"] > 0.1
    assert abs(deltas["bf16"] - deltas["f32"]) <= 0.05 * deltas["f32"], deltas
