"""Loop closure of the port against the JAX package.

Fast: one `Backend.loop_ba` on a pendulum state. The Synthetic trajectory
with `loop_period` P retraces itself, frame 2P - j at frame j's exact pose,
so among 28 keyframes (every frame admitted by the JAX motion filter, with
the in-repo checkpoint in float32) the last ones revisit the first more
than 20 keyframes apart — the reference's loop-edge gate. The scene is
88x120, a size no other test traces: the JAX package's jitted network
functions read SPLATSLAM_F32_NET when they trace, so a program compiled
at a shared size in bf16 could be handed to this file. Poses and
disparities are the ground truth, perturbed; the same video state goes into
both packages through `convert`. The loop edge set (ii, jj) must be equal
and hold loop edges; poses and disparities after the loop BA within 2e-4,
the update-rounds tolerance of tests/test_torch_learned_tracking.py.

Slow: the port's counterpart of tests/test_loop_closure.py, the same
configuration (100 frames, 96x128, pendulum period 48, only tracking, final
BA off) and the same gates.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu_torch import convert
from splatslam_tpu_torch.models import weights as tweights
from splatslam_tpu_torch.tracking import backend as tbk
from splatslam_tpu_torch.tracking import depth_video as tdv
from splatslam_tpu_torch.tracking import factor_graph as tfg
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "pretrained/droid_dba.msgpack")
N_KF, PERIOD, BUF = 28, 13, 32


def _cfg(tmp_path, enable_loop=True):
    """tests/test_loop_closure.py's configuration."""
    import test_loop_closure
    return test_loop_closure._cfg(tmp_path, enable_loop)


@pytest.fixture(scope="module")
def f32_net():
    old = os.environ.get("SPLATSLAM_F32_NET")
    os.environ["SPLATSLAM_F32_NET"] = "1"
    yield
    if old is None:
        os.environ.pop("SPLATSLAM_F32_NET", None)
    else:
        os.environ["SPLATSLAM_F32_NET"] = old


@pytest.fixture(scope="module")
def pendulum(f32_net, tmp_path_factory):
    """The JAX video of N_KF keyframes of the pendulum scene, GT poses and
    disparities perturbed, and its numpy snapshot."""
    from splatslam_tpu.datasets import Synthetic
    from splatslam_tpu.models import load_droid_params
    from splatslam_tpu import tracking as jtr
    from splatslam_tpu.ops import lie as jlie
    cfg = _cfg(tmp_path_factory.mktemp("loop"))
    cfg["synthetic"].update(n_frames=N_KF, loop_period=PERIOD)
    cfg["max_frames"] = N_KF
    cfg["tracking"]["buffer"] = BUF
    cfg["tracking"]["motion_filter"]["thresh"] = -1.0     # admit every frame
    cfg["cam"].update(H=88, W=120, H_out=88, W_out=120, cx=59.5, cy=43.5)
    ds = Synthetic(cfg)
    params = load_droid_params(CKPT)
    video = jtr.DepthVideo(cfg)
    mf = jtr.MotionFilter(params, video, cfg,
                          mono_fn=lambda t, img: ds[int(t)][2])
    intr = np.asarray(ds.get_intrinsic())
    for k in range(N_KF):
        assert mf.track(float(k), jnp.asarray(ds[k][1]), intr)
    assert video.counter == N_KF
    H, W = cfg["cam"]["H_out"], cfg["cam"]["W_out"]
    rng = np.random.RandomState(0)
    s = video.state
    poses = np.asarray(s.poses).copy()
    disps = np.asarray(s.disps).copy()
    for k in range(N_KF):
        poses[k] = jlie.from_matrix_np(np.linalg.inv(ds[k][3]) @ ds[0][3])
        disps[k] = 1.0 / np.maximum(ds[k][2][3::8, 3::8][:H // 8, :W // 8],
                                    1e-6)
    xi = np.zeros((BUF, 6), np.float32)
    xi[1:N_KF] = rng.randn(N_KF - 1, 6) * [.01, .01, .01, .002, .002, .002]
    s.poses = jlie.mul(jlie.exp(jnp.asarray(xi)), jnp.asarray(poses))
    disps[:N_KF] *= (1 + 0.05 * rng.randn(N_KF, H // 8, W // 8)).astype(
        np.float32)
    s.disps = jnp.asarray(disps)
    video.pose_gen += 1
    snap = {f: np.asarray(getattr(s, f)) for f in s.__dataclass_fields__}
    return dict(cfg=cfg, params=params, video=video, snap=snap)


def _spy_edges(monkeypatch, cls, edges):
    orig = cls.update_lowmem

    def spy(self, *a, **kw):
        edges.append(sorted(zip(np.asarray(self.ii).tolist(),
                                np.asarray(self.jj).tolist())))
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, "update_lowmem", spy)


def test_loop_ba_matches_jax(pendulum, monkeypatch):
    from splatslam_tpu.tracking import backend as jbk
    from splatslam_tpu.tracking import factor_graph as jfg
    cfg = pendulum["cfg"]
    edges_j, edges_t = [], []
    _spy_edges(monkeypatch, jfg.FactorGraph, edges_j)
    _spy_edges(monkeypatch, tfg.FactorGraph, edges_t)

    video = pendulum["video"]
    win_j, n_j = jbk.Backend(pendulum["params"], video, cfg).loop_ba(
        t_start=0, t_end=N_KF, steps=4)

    model = tweights.load_droid_params(CKPT, device="cpu")
    assert model.dtype == torch.float32
    v = tdv.DepthVideo(cfg, device="cpu")
    v.state = convert.video_state_from_numpy(pendulum["snap"], device="cpu")
    v.counter = N_KF
    win_t, n_t = tbk.Backend(model, v, cfg).loop_ba(t_start=0, t_end=N_KF,
                                                    steps=4)

    assert (win_t, n_t) == (win_j, n_j)
    assert len(edges_j) == len(edges_t) == 1
    assert edges_t[0] == edges_j[0]
    loop = [(i, j) for i, j in edges_t[0] if i - j > 20]
    print(f"{n_t} edges, {len(loop)} loop edges: {loop}")
    assert loop, "the pendulum state gave no loop edge"
    s = video.state
    for name, want in (("poses", s.poses), ("disps", s.disps)):
        np.testing.assert_allclose(
            getattr(v.state, name)[:N_KF].numpy(),
            np.asarray(want)[:N_KF], atol=2e-4, err_msg=name)


def _run_port(cfg, record=None):
    from splatslam_tpu_torch.slam import SLAM
    slam = SLAM(cfg, device="cpu")
    if record is None:
        return slam.run()["ate_stats"]
    orig = tbk.Backend.loop_ba

    def spy(self, *a, **kw):
        win, n_edges = orig(self, *a, **kw)
        record.append(n_edges)
        return win, n_edges

    tbk.Backend.loop_ba = spy
    try:
        return slam.run()["ate_stats"]
    finally:
        tbk.Backend.loop_ba = orig


@pytest.mark.slow
def test_learned_loop_closure_at_scale(tmp_path, monkeypatch):
    """tests/test_loop_closure.py through the port (its gates: loop_ba
    fires and builds edges, kf-ATE finite, below 0.25 and 0.5% below the
    loop-disabled arm's)."""
    monkeypatch.chdir(REPO)
    loop_edges = []
    ate_loop = _run_port(_cfg(tmp_path, True), record=loop_edges)
    ate_base = _run_port(_cfg(tmp_path, False))
    print("loop edges", loop_edges, "kf-ATE", ate_loop["rmse"],
          ate_base["rmse"])
    assert loop_edges, "loop_ba never fired"
    assert max(loop_edges) > 0, \
        f"loop_ba fired {len(loop_edges)} times but never built an edge"
    assert np.isfinite(ate_loop["rmse"]) and np.isfinite(ate_base["rmse"])
    assert ate_loop["rmse"] < 0.25, ate_loop
    assert ate_loop["rmse"] < ate_base["rmse"] * 0.995, \
        (ate_loop["rmse"], ate_base["rmse"])
