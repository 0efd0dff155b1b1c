"""Camera-parallel mapping over a device list (the port's counterpart of the
JAX mapper's "cam" mesh, tests/test_multichip.py:36,111).

One map_step_n segment with its camera rows split over a list of devices
must equal the same segment on one device at the JAX suite's own tolerances
for a mesh against one device (loss rtol 1e-5; xyz and opacity atol 1e-5,
rtol 1e-4; n_touched exact): the shards sum their gradients in another
order. The list repeats the CPU, so every shard has a replica of its own
that aliases nothing: a second Adam step, or a replica left stale, shows.
Against the JAX package's segment on its 8-device virtual CPU mesh the
tolerances are those of tests/test_torch_mapping.py for map_step_n (loss
rtol 1e-3; the state rtol 1e-3, atol 1e-5).

Then SLAM with the mapper on an 8-entry CPU device list, and the fallback:
`mapping.mesh_devices: 2` with one visible device prints JAX's message and
runs the single-device path.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.mapping import gaussians as jG
from splatslam_tpu.mapping import mapper as jM
from splatslam_tpu_torch.convert import gaussian_state_from_numpy
from splatslam_tpu_torch.mapping import mapper as tM
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, K, C, B = 32, 32, 32, 512, 8
INTR = np.asarray([20.0, 20.0, W / 2.0, H / 2.0], np.float32)
LRS = dict(xyz=0.0, f_dc=0.0025, f_rest=1e-4, opacity=0.05, scaling=0.001,
           rotation=0.001)
LR_SCHED = (9.6e-4, 9.6e-6, 0.01, 30000)
CAM_LRS = (5e-4, 1.5e-3)
STATE_FIELDS = ("xyz", "f_dc", "opacity", "scaling", "rotation", "alive",
                "grad_accum", "denom", "max_radii2D")


def _inputs(seed=0, n_cams=B):
    """A JAX GaussianState of 128 Gaussians in front of n_cams cameras
    (small seeded translations) and the cameras' tensors, in numpy."""
    rng = np.random.RandomState(seed)
    st = jG.make_state(C)
    n = 128
    xyz = np.zeros((C, 3), np.float32)
    xyz[:, :2] = rng.randn(C, 2) * 0.5
    # evenly spaced depths, permuted: the binning sort has no ties
    xyz[:, 2] = 1.5 + rng.permutation(C) / C
    upd = dict(xyz=xyz, f_dc=rng.randn(C, 3) * 0.5,
               opacity=rng.uniform(-1.0, 2.0, (C, 1)),
               scaling=np.log(rng.uniform(0.03, 0.08, (C, 3))),
               rotation=rng.randn(C, 4), alive=np.arange(C) < n)
    st = dataclasses.replace(st, **{k: jnp.asarray(v, getattr(st, k).dtype)
                                    for k, v in upd.items()})
    w2cs = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    w2cs[:, :3, 3] = rng.randn(n_cams, 3) * [0.05, 0.05, 0.02]
    cams = dict(
        w2cs=w2cs, images=rng.rand(n_cams, H, W, 3).astype(np.float32),
        depths=np.full((n_cams, H, W), 1.8, np.float32),
        exposure=(0.05 * rng.randn(n_cams, 2)).astype(np.float32),
        use_exposure=np.arange(n_cams) > 0,
        cam_valid=np.ones(n_cams, bool),
        opt_pose_mask=np.arange(n_cams) % 2 == 1)
    return st, cams


def _as_numpy(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _run_port(st_j, cams, devices, per_step, opt_poses=True):
    st = gaussian_state_from_numpy(_as_numpy(st_j), device="cpu")
    n = cams["w2cs"].shape[0]
    T = lambda x: torch.as_tensor(np.array(x))
    z2, z6 = torch.zeros(n, 2), torch.zeros(n, 6)
    out = tM.map_step_n(
        st, (z2, z2.clone()), (z6, z6.clone()),
        *[T(cams[k]) for k in ("w2cs", "images", "depths", "exposure",
                               "use_exposure", "cam_valid",
                               "opt_pose_mask")],
        T(INTR), LRS, CAM_LRS, 3, n if per_step else 5, 10.0, H=H, W=W, K=K,
        use_ssim=False, alpha=0.8, lr_sched=LR_SCHED, opt_poses=opt_poses,
        rebin_every=2, per_step_cams=per_step, devices=devices)
    return out


def _assert_mesh_equal(got, want):
    """The JAX suite's tolerances for a mesh against one device."""
    np.testing.assert_allclose(float(got[-1]), float(want[-1]), rtol=1e-5)
    for name in ("xyz", "opacity"):
        np.testing.assert_allclose(getattr(got[0], name).numpy(),
                                   getattr(want[0], name).numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[6].numpy(), want[6].numpy())
    # the rows' own state comes back in row order
    for i, name in ((3, "w2cs"), (4, "exposure")):
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    for name in ("grad_accum", "denom", "max_radii2D"):
        np.testing.assert_allclose(getattr(got[0], name).numpy(),
                                   getattr(want[0], name).numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["batch", "per_step"])
def test_map_step_n_over_8_devices_matches_one_device(per_step):
    st_j, cams = _inputs(seed=1)
    one = _run_port(st_j, cams, None, per_step)
    eight = _run_port(st_j, cams, ["cpu"] * 8, per_step)
    assert np.isfinite(float(eight[-1]))
    assert int(one[6].sum()) > 0
    _assert_mesh_equal(eight, one)


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["batch", "per_step"])
def test_uneven_split_matches_one_device(per_step):
    """3 devices, 8 cameras: shards of 3, 3 and 2 rows."""
    st_j, cams = _inputs(seed=2)
    one = _run_port(st_j, cams, None, per_step)
    three = _run_port(st_j, cams, ["cpu"] * 3, per_step)
    _assert_mesh_equal(three, one)


def test_more_devices_than_cameras():
    """A 3-camera window over 8 devices: five shards are empty."""
    st_j, cams = _inputs(seed=3, n_cams=3)
    one = _run_port(st_j, cams, None, False)
    eight = _run_port(st_j, cams, ["cpu"] * 8, False)
    _assert_mesh_equal(eight, one)


@pytest.mark.parametrize("prebinned", [False, True],
                         ids=["bins", "prebinned"])
def test_map_step_over_devices_matches_one_device(prebinned):
    """One map_step, its tile lists binned inside or handed in and split
    with the rows."""
    st_j, cams = _inputs(seed=5)
    T = lambda x: torch.as_tensor(np.array(x))
    outs = []
    for devices in (None, ["cpu"] * 3):
        st = gaussian_state_from_numpy(_as_numpy(st_j), device="cpu")
        w2cs = T(cams["w2cs"])
        tiles = tM._rebin(st, w2cs, T(INTR), H=H, W=W, K=K, margin=4.0,
                          rebin_every=8, max_span=4) if prebinned \
            else (None, None)
        z2, z6 = torch.zeros(B, 2), torch.zeros(B, 6)
        outs.append(tM.map_step(
            st, (z2, z2), (z6, z6), w2cs,
            *[T(cams[k]) for k in ("images", "depths", "exposure",
                                   "use_exposure", "cam_valid",
                                   "opt_pose_mask")],
            T(INTR), LRS, CAM_LRS, 1, 10.0, *tiles, H=H, W=W, K=K,
            use_ssim=True, alpha=0.8, opt_poses=True, devices=devices))
    _assert_mesh_equal(outs[1], outs[0])


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["batch", "per_step"])
def test_map_step_n_over_devices_matches_jax_mesh(per_step):
    """The port over 8 CPU devices against the JAX segment sharded over the
    8-device virtual CPU mesh (the placement of tests/test_multichip.py)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    cpu = jax.devices("cpu")
    assert len(cpu) >= 8, "conftest forces 8 virtual CPU devices"
    mesh = Mesh(np.asarray(cpu[:8]), ("cam",))
    put_c = lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh,
                                                                   P("cam")))
    put_r = lambda x: jax.device_put(x, NamedSharding(mesh, P()))
    st_j, cams = _inputs(seed=4)
    z2, z6 = np.zeros((B, 2), np.float32), np.zeros((B, 6), np.float32)
    out_j = jM.map_step_n(
        jax.tree_util.tree_map(put_r, st_j), (put_c(z2), put_c(z2)),
        (put_c(z6), put_c(z6)),
        *[put_c(cams[k]) for k in ("w2cs", "images", "depths", "exposure",
                                   "use_exposure", "cam_valid",
                                   "opt_pose_mask")],
        jnp.asarray(INTR), LRS, (jnp.asarray(CAM_LRS[0]),
                                 jnp.asarray(CAM_LRS[1])),
        jnp.asarray(3), jnp.asarray(B if per_step else 5), jnp.asarray(10.0),
        H=H, W=W, K=K, use_ssim=False, alpha=0.8, lr_sched=LR_SCHED,
        opt_poses=True, rebin_every=2, per_step_cams=per_step)
    out_t = _run_port(st_j, cams, ["cpu"] * 8, per_step)
    np.testing.assert_allclose(float(out_t[-1]), float(out_j[-1]), rtol=1e-3)
    for name, want in _as_numpy(out_j[0]).items():
        if name in STATE_FIELDS:
            np.testing.assert_allclose(getattr(out_t[0], name).numpy(), want,
                                       rtol=1e-3, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out_t[3].numpy(), np.asarray(out_j[3]),
                               rtol=1e-3, atol=1e-5)          # w2cs
    np.testing.assert_allclose(out_t[4].numpy(), np.asarray(out_j[4]),
                               rtol=1e-3, atol=1e-5)          # exposure
    np.testing.assert_array_equal(out_t[6].numpy(), np.asarray(out_j[6]))


def _slam_cfg(out_dir):
    from test_torch_slam import _cfg
    cfg = _cfg(out_dir)
    # 4 fused refine steps: a mesh rounds them up to lcm(4, n)
    cfg["mapping"].update(final_refine_iters=8, refine_fused_steps=4)
    return cfg


def test_slam_with_the_mapper_on_a_device_list(tmp_path, monkeypatch):
    """The shrunk oracle SLAM with the mapper's rows over 8 CPU entries:
    initialisation, window optimisation, pruning and the final refine (its
    segments rounded to lcm(4, 8) steps) run sharded and end finite."""
    from splatslam_tpu_torch.slam import SLAM
    monkeypatch.chdir(REPO)
    slam = SLAM(_slam_cfg(tmp_path), device="cpu",
                mapping_devices=["cpu"] * 8)
    assert slam.mapper.devices == [torch.device("cpu")] * 8
    seen = []
    orig = tM.map_step_n

    def spy(*a, **kw):
        seen.append((kw["devices"], kw["per_step_cams"], a[14]))
        return orig(*a, **kw)

    monkeypatch.setattr(tM, "map_step_n", spy)
    res = slam.run()
    st = slam.mapper.st
    assert bool(torch.isfinite(st.xyz).all())
    assert int(st.alive.sum()) > 0
    assert np.isfinite(res["ate_rmse"]) and np.isfinite(res["psnr"])
    assert seen and all(d is slam.mapper.devices for d, _, _ in seen)
    # final_refine's per-step segments fill the 8-device bucket
    assert {n for _, per_step, n in seen if per_step} == {8}


def test_mesh_devices_above_the_visible_falls_back(tmp_path, monkeypatch,
                                                   capsys):
    """mesh_devices 2 on a one-device machine: JAX's message, then the run
    of mesh_devices 0, keyframe for keyframe."""
    from splatslam_tpu_torch.slam import SLAM
    monkeypatch.chdir(REPO)
    runs = {}
    for n in (2, 0):
        cfg = _slam_cfg(tmp_path / str(n))
        cfg["mapping"]["mesh_devices"] = n
        slam = SLAM(cfg, device="cpu")
        out = capsys.readouterr().out
        assert slam.mapper.devices is None
        if n:
            assert ("[mapper] mesh_devices=2 requested but only 1 devices "
                    "visible — running single-chip") in out
        res = slam.run()
        runs[n] = (res, np.asarray(slam.video.state.timestamp[
            :slam.video.counter]).tolist())
    assert runs[2][1] == runs[0][1]
    assert runs[2][0]["n_keyframes"] == runs[0][0]["n_keyframes"]
    assert runs[2][0]["ate_rmse"] == runs[0][0]["ate_rmse"]


def test_cuda_device_without_index_is_the_current_card(monkeypatch):
    """A CUDA device without an index is the current card, in the device
    list's check and in mesh_devices (the run's device is `cuda` by
    default); the card count and the current card are stood in for."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tM._indexed("cuda") == torch.device("cuda", 1)
    assert tM._indexed("cuda:0") == torch.device("cuda", 0)
    assert tM._indexed("cpu") == torch.device("cpu")
    assert tM.mesh_devices(2, torch.device("cuda")) == [
        torch.device("cuda", 1), torch.device("cuda", 0)]
