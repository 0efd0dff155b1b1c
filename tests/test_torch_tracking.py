"""Oracle tracking parity: the PyTorch port's MotionFilter + Frontend
against the JAX package's on the first Synthetic frames at 96×128.

Both packages see the same frames, GT poses and GT depths; tracking is
deterministic (oracle flow targets, no random draws), so keyframe
admission must agree exactly and the keyframe poses to 1e-4 — float32
Gauss-Newton with a different summation order in the Schur assembly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.models import init_params
from splatslam_tpu.ops import lie as jlie
from splatslam_tpu import tracking as jtr
from splatslam_tpu.datasets import Synthetic as JSynthetic
from splatslam_tpu_torch.models.droid_net import DroidNet
from splatslam_tpu_torch.tracking.depth_video import DepthVideo
from splatslam_tpu_torch.tracking.motion_filter import MotionFilter
from splatslam_tpu_torch.tracking.frontend import Frontend
from splatslam_tpu_torch.tracking.backend import Backend
from splatslam_tpu_torch.ops import lie as tlie


def _cfg(n_frames=10):
    return {
        "dataset": "synthetic",
        "synthetic": {"n_frames": n_frames, "seed": 7, "motion_scale": 5.0},
        "cam": {"H": 96, "W": 128, "fx": 80.0, "fy": 80.0, "cx": 63.5,
                "cy": 47.5, "H_edge": 0, "W_edge": 0, "H_out": 96,
                "W_out": 128},
        "tracking": {
            "oracle": True, "buffer": 16, "beta": 0.6, "warmup": 5,
            "max_age": 25, "mono_thres": False,
            "motion_filter": {"thresh": 0.2},
            "multiview_filter": {"thresh": 0.01, "visible_num": 2},
            "frontend": {"enable_loop": False, "enable_online_ba": False,
                         "keyframe_thresh": 0.1, "thresh": 1e9,
                         "window": 8, "radius": 2, "nms": 1,
                         "max_factors": 48},
            "backend": {"final_ba": True, "ba_freq": 8, "thresh": 1e9,
                        "radius": 1, "nms": 2, "loop_window": 8,
                        "loop_thresh": 1e9, "loop_radius": 1, "loop_nms": 2,
                        "BA_type": "DSPO", "normalize": False},
        },
    }


def _run_jax(cfg, ds, dense_ba):
    params = init_params(jax.random.PRNGKey(0), H=96, W=128)
    video = jtr.DepthVideo(cfg)
    mono = lambda t, img: ds[int(t)][2] * 0.5 + 0.3
    mf = jtr.MotionFilter(params, video, cfg, mono_fn=mono)
    fe = jtr.Frontend(params, video, cfg)
    intr = np.asarray(ds.get_intrinsic())
    for k in range(len(ds)):
        _, img, dep, c2w = ds[k]
        mf.track(float(k), jnp.asarray(img), intr,
                 gt_pose=jlie.from_matrix_np(np.linalg.inv(c2w)),
                 gt_depth=dep)
        fe()
    if dense_ba:
        jtr.Backend(params, video, cfg).dense_ba(2)
    n = video.counter
    return (n, np.asarray(video.state.poses[:n]),
            np.asarray(video.state.timestamp[:n]),
            np.asarray(video.state.disps[:n]))


def _run_torch(cfg, ds, dense_ba):
    # the oracle update never runs the network; admitted keyframes are
    # still encoded, so the filter wants one (random weights will do)
    model = DroidNet(device="cpu", generator=torch.Generator().manual_seed(0))
    video = DepthVideo(cfg, device="cpu")
    mono = lambda t, img: ds[int(t)][2] * 0.5 + 0.3
    mf = MotionFilter(model, video, cfg, mono_fn=mono)
    fe = Frontend(model, video, cfg)
    intr = np.asarray(ds.get_intrinsic())
    for k in range(len(ds)):
        _, img, dep, c2w = ds[k]
        mf.track(float(k), img, intr,
                 gt_pose=tlie.from_matrix_np(np.linalg.inv(c2w)),
                 gt_depth=dep)
        fe()
    if dense_ba:
        Backend(model, video, cfg).dense_ba(2)
    n = video.counter
    s = video.state
    return n, s.poses[:n].numpy(), s.timestamp[:n].numpy(), s.disps[:n].numpy()


@pytest.mark.parametrize("dense_ba", [False, True],
                         ids=["frontend", "frontend+dense_ba"])
def test_oracle_frontend_matches_jax(dense_ba):
    cfg = _cfg()
    ds = JSynthetic(cfg)
    n_j, poses_j, ts_j, disps_j = _run_jax(cfg, ds, dense_ba)
    n_t, poses_t, ts_t, disps_t = _run_torch(cfg, ds, dense_ba)
    assert n_t == n_j and n_j >= 5
    np.testing.assert_array_equal(ts_t, ts_j)
    # the quaternion sign is a free choice: compare as 4×4 matrices
    mj = np.asarray(jax.vmap(jlie.to_matrix)(jnp.asarray(poses_j)))
    mt = tlie.to_matrix(torch.as_tensor(poses_t)).numpy()
    np.testing.assert_allclose(mt, mj, atol=1e-4)
    np.testing.assert_allclose(disps_t, disps_j, rtol=1e-3, atol=1e-4)


def test_synthetic_dataset_bit_identical():
    from splatslam_tpu_torch.datasets import Synthetic as TSynthetic
    cfg = _cfg(n_frames=6)
    dj, dt = JSynthetic(cfg), TSynthetic(cfg)
    assert len(dj) == len(dt) == 6
    np.testing.assert_array_equal(dt.get_intrinsic(), dj.get_intrinsic())
    for k in (0, 3, 5):
        for a, b in zip(dt[k], dj[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_video_kernels_match_jax_on_carried_state():
    """frame_distance, depth_filter, the multiview masks and reproject on a
    JAX VideoState carried across by convert.video_state_from_numpy."""
    from splatslam_tpu.tracking import depth_video as jdv
    from splatslam_tpu_torch.tracking import depth_video as tdv
    from splatslam_tpu_torch.convert import video_state_from_numpy
    rng = np.random.RandomState(0)
    st = jdv.make_video_state(8, 48, 64)
    n, h, w = 6, 6, 8
    xs = np.cumsum(rng.randn(n, 6) * np.array([0.03, 0.03, 0.05, 0.01, 0.01,
                                                0.01]), 0).astype(np.float32)
    poses = np.asarray(st.poses).copy()
    poses[:n] = np.asarray(jlie.exp(jnp.asarray(xs)))
    disps = np.asarray(st.disps).copy()
    disps[:n] = 0.4 + 0.2 * rng.rand(n, h, w)
    st = st.__class__(**{**{f: getattr(st, f) for f in
                            st.__dataclass_fields__},
                         "poses": jnp.asarray(poses),
                         "disps": jnp.asarray(disps)})
    ts = video_state_from_numpy(
        {f: np.asarray(getattr(st, f)) for f in st.__dataclass_fields__},
        device="cpu")
    intr =np.asarray([6.0, 6.0, 4.0, 3.0], np.float32)
    ii = np.asarray([0, 1, 2, 3, 4, 5, 2], np.int64)
    jj = np.asarray([1, 2, 3, 4, 5, 0, 2], np.int64)
    want = jdv.frame_distance_kernel(st.poses, st.disps, jnp.asarray(intr),
                                     jnp.asarray(ii), jnp.asarray(jj), 0.6)
    got = tdv.frame_distance(ts.poses, ts.disps, torch.as_tensor(intr),
                             torch.as_tensor(ii), torch.as_tensor(jj), 0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    inds = np.arange(n)
    thr = np.full(n, 0.05, np.float32)
    want = jdv.depth_filter_kernel(st.poses, st.disps, jnp.asarray(intr),
                                   jnp.asarray(inds), jnp.asarray(thr))
    got = tdv.depth_filter(ts.poses, ts.disps, torch.as_tensor(intr),
                           torch.as_tensor(inds), torch.as_tensor(thr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jdv._valid_mask_kernel(
        st.poses, st.disps, st.valid_depth_mask_small, jnp.asarray(intr),
        jnp.asarray(inds, jnp.int32), thresh_mult=0.05, visible_num=2,
        intr_scale=1.0)[:n]
    got = tdv.valid_depth_masks(ts.poses, ts.disps, torch.as_tensor(intr),
                                torch.as_tensor(inds), 0.05, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cw, vw = jdv.reproject_kernel(st.poses, st.disps, jnp.asarray(intr),
                                  jnp.asarray(ii), jnp.asarray(jj))
    cg, vg = tdv.reproject(ts.poses, ts.disps, torch.as_tensor(intr),
                           torch.as_tensor(ii), torch.as_tensor(jj))
    np.testing.assert_allclose(cg.numpy(), np.asarray(cw), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vw))
