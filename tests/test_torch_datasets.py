"""Recorded-sequence readers: the port's Replica / ScanNet / TUM-RGBD loaders
against the JAX package's on the same on-disk trees.

The trees are written once from the Synthetic renderer in the layouts of
src/utils/datasets.py:219-385 (as tests/test_dataset_fixtures.py does):
  Replica  results/frame%06d.jpg + results/depth%06d.png + traj.txt
  ScanNet  color/%d.jpg + depth/%d.png + pose/%d.txt (numeric order: 10
           frames and more, so that "10" must sort after "9")
  TUM      rgb.txt / depth.txt / groundtruth.txt, quaternion poses,
           jittered timestamps that need association, a 40 Hz burst that the
           32 Hz thinning must drop

Frames, poses, intrinsics and lengths must be bit-identical
(`np.array_equal`); the TUM tree then runs through both SLAMs with oracle
tracking: same keyframes, kf-ATE within 1e-3.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from splatslam_tpu import datasets as jds
from splatslam_tpu_torch import datasets as tds
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12
H, W = 96, 128
FX = FY = 80.0
CX, CY = (W - 1) / 2.0, (H - 1) / 2.0
DEPTH_SCALE = {"replica": 1000.0, "scannet": 1000.0, "tumrgbd": 5000.0}


def _cam_cfg(fmt):
    return dict(H=H, W=W, fx=FX, fy=FY, cx=CX, cy=CY, H_out=H, W_out=W,
                H_edge=0, W_edge=0, png_depth_scale=DEPTH_SCALE[fmt])


def _write_img(path, color):
    bgr = (np.clip(color, 0, 1) * 255).astype(np.uint8)[..., ::-1]
    assert cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, 97])


def _write_depth16(path, depth, scale):
    assert cv2.imwrite(path, np.round(depth * scale).astype(np.uint16))


def _rows(c2w):
    return [" ".join(f"{v:.9f}" for v in row) for row in np.asarray(c2w)]


def make_replica_scene(root, frames):
    os.makedirs(os.path.join(root, "results"))
    for i, (_, color, depth, _) in enumerate(frames):
        _write_img(os.path.join(root, "results", f"frame{i:06d}.jpg"), color)
        _write_depth16(os.path.join(root, "results", f"depth{i:06d}.png"),
                       depth, DEPTH_SCALE["replica"])
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(" ".join(_rows(c2w)) for *_, c2w in frames) + "\n")


def make_scannet_scene(root, frames):
    for d in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, d))
    for i, (_, color, depth, c2w) in enumerate(frames):
        _write_img(os.path.join(root, "color", f"{i}.jpg"), color)
        _write_depth16(os.path.join(root, "depth", f"{i}.png"), depth,
                       DEPTH_SCALE["scannet"])
        with open(os.path.join(root, "pose", f"{i}.txt"), "w") as f:
            f.write("\n".join(_rows(c2w)) + "\n")


def make_tum_scene(root, frames):
    from scipy.spatial.transform import Rotation
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d))
    rgb_l, dep_l, gt_l = [], [], []
    rng = np.random.RandomState(5)
    t = 1000.0
    for i, (_, color, depth, c2w) in enumerate(frames):
        # frames 5 and 6 follow their predecessors by 25 ms (40 Hz): the
        # 32 Hz thinning keeps 4, drops 5, keeps 6 (50 ms after 4)
        t += 0.025 if i in (5, 6) else 0.2
        t_rgb, t_dep, t_pose = t + rng.uniform(-0.004, 0.004, 3)
        _write_img(os.path.join(root, "rgb", f"{t_rgb:.6f}.jpg"), color)
        _write_depth16(os.path.join(root, "depth", f"{t_dep:.6f}.png"),
                       depth, DEPTH_SCALE["tumrgbd"])
        rgb_l.append(f"{t_rgb:.6f} rgb/{t_rgb:.6f}.jpg")
        dep_l.append(f"{t_dep:.6f} depth/{t_dep:.6f}.png")
        q = Rotation.from_matrix(np.asarray(c2w)[:3, :3]).as_quat()
        tx, ty, tz = np.asarray(c2w)[:3, 3]
        gt_l.append(f"{t_pose:.6f} {tx:.9f} {ty:.9f} {tz:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
    # one colour frame with no depth or pose within 80 ms: dropped
    rgb_l.append(f"{t + 1.0:.6f} rgb/none.jpg")
    for name, lines, head in (("rgb.txt", rgb_l, ""), ("depth.txt", dep_l, ""),
                              ("groundtruth.txt", gt_l,
                               "# timestamp tx ty tz qx qy qz qw\n")):
        with open(os.path.join(root, name), "w") as f:
            f.write(head + "\n".join(lines) + "\n")


MAKERS = {"replica": make_replica_scene, "scannet": make_scannet_scene,
          "tumrgbd": make_tum_scene}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{format: root of its tree}, written once from 12 Synthetic frames."""
    src = tds.Synthetic({"dataset": "synthetic", "cam": _cam_cfg("replica"),
                         "synthetic": {"n_frames": N_FRAMES, "seed": 3,
                                       "motion_scale": 5.0}})
    frames = [src[i] for i in range(N_FRAMES)]
    roots = {}
    for fmt, make in MAKERS.items():
        roots[fmt] = str(tmp_path_factory.mktemp("scenes") / fmt)
        make(roots[fmt], frames)
    return roots


def _reader_cfg(fmt, root, case):
    cfg = {"dataset": fmt, "cam": _cam_cfg(fmt),
           "data": {"dataset_root": root, "input_folder": ""}}
    if case == "stride":
        cfg.update(stride=2, max_frames=9)
    elif case == "edge_crop":
        cfg["cam"].update(H_edge=6, W_edge=10, H_out=60, W_out=90)
    elif case == "distortion":
        cfg["cam"].update(distortion=[0.12, -0.2, 0.001, -0.002, 0.05],
                          H_out=72, W_out=100)
    elif case != "plain":
        raise KeyError(case)
    return cfg


@pytest.mark.parametrize("case", ["plain", "stride", "edge_crop",
                                  "distortion"])
@pytest.mark.parametrize("fmt", ["replica", "scannet", "tumrgbd"])
def test_reader_is_bit_identical_to_jax(scenes, fmt, case):
    cfg = _reader_cfg(fmt, scenes[fmt], case)
    want, got = jds.get_dataset(cfg), tds.get_dataset(cfg)
    assert type(got).__name__ == type(want).__name__
    # TUM: 12 frames written, frame 5 thinned out, the orphan never matched
    n_all = N_FRAMES - 1 if fmt == "tumrgbd" else N_FRAMES
    assert len(got) == len(want) == (
        len(range(0, min(9, n_all), 2)) if case == "stride" else n_all)
    assert np.array_equal(got.get_intrinsic(), want.get_intrinsic())
    for name in ("fx", "fy", "cx", "cy", "fovx", "fovy", "H_out", "W_out",
                 "H_edge", "W_edge", "png_depth_scale", "input_folder",
                 "fx_orig", "fy_orig", "cx_orig", "cy_orig"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.color_paths == want.color_paths
    assert got.depth_paths == want.depth_paths
    cam = cfg["cam"]
    for i in range(len(want)):
        wi, wc, wd, wp = want[i]
        gi, gc, gd, gp = got[i]
        assert gi == wi == i
        assert gc.shape == (cam["H_out"], cam["W_out"], 3)
        assert gd.shape == (cam["H_out"], cam["W_out"])
        assert gc.dtype == gd.dtype == gp.dtype == np.float32
        assert np.array_equal(gc, wc), f"colour of frame {i}"
        assert np.array_equal(gd, wd), f"depth of frame {i}"
        assert np.array_equal(gp, wp), f"pose of frame {i}"
        assert np.array_equal(got.get_gt_pose(i), want.get_gt_pose(i))
    assert gd.max() > 1.0 and gc.max() > 0.5          # real content


def test_tum_reader_thins_and_normalises(scenes):
    ds = tds.get_dataset(_reader_cfg("tumrgbd", scenes["tumrgbd"], "plain"))
    stamps = [float(os.path.basename(p)[:-4]) for p in ds.color_paths]
    assert min(np.diff(stamps)) > 1.0 / 32
    assert np.array_equal(ds[0][3], np.eye(4, dtype=np.float32))
    assert not any(p.endswith("none.jpg") for p in ds.color_paths)


def test_scannet_reader_orders_numerically(scenes):
    ds = tds.get_dataset(_reader_cfg("scannet", scenes["scannet"], "plain"))
    assert [os.path.basename(p) for p in ds.color_paths] == [
        f"{i}.jpg" for i in range(N_FRAMES)]


def test_reader_errors_name_their_cause(scenes, monkeypatch, tmp_path):
    with pytest.raises(KeyError, match="unknown dataset 'kitti'"):
        tds.get_dataset({"dataset": "kitti"})
    ds = tds.get_dataset(_reader_cfg("replica", scenes["replica"], "plain"))
    ds.depth_paths[2] = str(tmp_path / "gone.png")
    with pytest.raises(FileNotFoundError, match="gone.png"):
        ds[2]
    monkeypatch.setattr(tds, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        ds[0]
    # the procedural scene needs no cv2
    syn = tds.get_dataset({"dataset": "synthetic", "cam": _cam_cfg("replica"),
                           "synthetic": {"n_frames": 2}})
    assert syn[1][1].shape == (H, W, 3)


def _slam_cfg(load_config, scene_dir, out_dir, fmt="tumrgbd"):
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    cfg.pop("inherit_from", None)
    cfg.update(dataset=fmt, scene="fixture_tum", verbose=False,
               max_frames=N_FRAMES, eval_full_traj=False, eval_plots=False)
    cfg["cam"] = dict(cfg["cam"], **_cam_cfg(fmt))
    cfg["data"] = {"dataset_root": scene_dir, "input_folder": "",
                   "output": str(out_dir)}
    cfg["mono_prior"]["provider"] = "oracle"
    cfg["tracking"].update(buffer=16, warmup=4)
    cfg["tracking"]["motion_filter"]["thresh"] = 0.2
    cfg["tracking"]["frontend"]["keyframe_thresh"] = 0.1
    cfg["mapping"].update(capacity=8192, raster_K=64, final_refine_iters=8)
    cfg["mapping"]["Training"].update(init_itr_num=16, mapping_itr_num=8)
    cfg["meshing"]["mesh"] = False
    return cfg


def test_tum_fixture_runs_through_both_slams(scenes, tmp_path, monkeypatch):
    """The recorded-sequence path as a whole, oracle tracking on both sides:
    the port's CLI at --device cpu against the JAX SLAM."""
    import yaml
    from splatslam_tpu.config import load_config as jload
    from splatslam_tpu.slam import SLAM as JSLAM
    from splatslam_tpu_torch import run
    from splatslam_tpu_torch.config import load_config as tload
    monkeypatch.chdir(REPO)
    path = tmp_path / "tum.yaml"
    with open(path, "w") as f:
        yaml.dump(_slam_cfg(tload, scenes["tumrgbd"], tmp_path / "torch"), f)
    got = run.main([str(path), "--device", "cpu"])
    jslam = JSLAM(_slam_cfg(jload, scenes["tumrgbd"], tmp_path / "jax"))
    want = jslam.run()
    with np.load(tmp_path / "torch" / "fixture_tum" / "video.npz") as d:
        stamps = d["timestamps"].tolist()
    want_stamps = np.asarray(
        jslam.video.state.timestamp[:jslam.video.counter]).tolist()
    print("port kf-ATE", got["ate_rmse"], "jax", want["rmse"], stamps)
    assert stamps == want_stamps and len(stamps) >= 5
    assert abs(got["ate_rmse"] - want["rmse"]) <= 1e-3
    assert got["ate_rmse"] < 0.05
    assert np.isfinite(got["psnr"]) and np.isfinite(got["depth_l1"])


@pytest.mark.parametrize("fmt", ["replica", "scannet"])
def test_fixture_tree_runs_through_the_cli(scenes, fmt, tmp_path, monkeypatch):
    """The other two layouts through `python -m splatslam_tpu_torch.run
    <yaml> --device cpu`, oracle tracking: the GT trajectory comes back."""
    import yaml
    from splatslam_tpu_torch import run
    from splatslam_tpu_torch.config import load_config
    monkeypatch.chdir(REPO)
    path = tmp_path / f"{fmt}.yaml"
    with open(path, "w") as f:
        yaml.dump(_slam_cfg(load_config, scenes[fmt], tmp_path / "out", fmt),
                  f)
    got = run.main([str(path), "--device", "cpu"])
    assert got["n_frames"] == N_FRAMES and got["n_keyframes"] >= 5
    assert got["ate_rmse"] < 0.05
    assert np.isfinite(got["psnr"]) and np.isfinite(got["depth_l1"])
