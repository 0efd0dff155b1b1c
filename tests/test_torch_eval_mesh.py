"""Meshing and the evaluation artefacts of the port.

TSDF integration is held against the JAX package's TSDFVolume on the same
frames (allclose 1e-5 on the TSDF, the weights and the colours; a voxel whose
projection lies within 1e-3 px of a rounding boundary may land on the
neighbouring pixel in either package and is left out of the comparison —
it is counted, and at most a handful may be); marching tetrahedra, mesh
cleaning, the F-score and the PLY round trips are checked as
tests/test_eval_and_mesh.py checks the JAX package's; one tiny mapped run
writes every artefact: mesh.ply, the per-keyframe panels, the gif, the
trajectory figures, the online plots and the evaluation before the final BA.
"""

import os

import numpy as np
import pytest
import torch

from splatslam_tpu.utils import mesh as jmesh
from splatslam_tpu_torch.datasets import Synthetic
from splatslam_tpu_torch.mapping import gaussians as G
from splatslam_tpu_torch.utils import eval_traj, mesh as tmesh
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(bounds, **kw):
    return (jmesh.TSDFVolume(*bounds, **kw),
            tmesh.TSDFVolume(*bounds, device="cpu", **kw))


def _grids(jv, tv):
    return ((np.asarray(jv.tsdf), np.asarray(jv.weight), np.asarray(jv.color)),
            (tv.tsdf.numpy(), tv.weight.numpy(), tv.color.numpy()))


def _near_rounding_boundary(vol, frames, tol=1e-3):
    """Voxels whose projection into any frame is within `tol` px of x.5."""
    nx, ny, nz = vol.tsdf.shape
    g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3)
    pts = vol.origin.numpy().astype(np.float64) + vol.voxel * g
    near = np.zeros(len(pts), bool)
    for _, _, w2c, (fx, fy, cx, cy) in frames:
        cam = pts @ np.asarray(w2c, np.float64)[:3, :3].T + w2c[:3, 3]
        z = np.clip(cam[:, 2], 1e-6, None)
        for uv in (fx * cam[:, 0] / z + cx, fy * cam[:, 1] / z + cy):
            near |= np.abs(uv - np.floor(uv) - 0.5) < tol
    return near.reshape(nx, ny, nz)


def test_tsdf_plane_matches_jax():
    H, W = 32, 48
    intr = (40.0, 40.0, W / 2, H / 2)
    depth = np.full((H, W), 2.0, np.float32)
    color = np.full((H, W, 3), 0.5, np.float32)
    jv, tv = _both(([-1.5, -1.0, 1.5], [1.5, 1.0, 2.5]), voxel=0.05,
                   trunc=0.15)
    assert tuple(tv.tsdf.shape) == tuple(jv.tsdf.shape)
    assert (tv.voxel, tv.trunc) == (jv.voxel, jv.trunc)
    jv.integrate(depth, color, np.eye(4), intr)
    tv.integrate(depth, color, np.eye(4), intr)
    for want, got in zip(*_grids(jv, tv)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    verts, faces = tv.extract_mesh()
    assert len(verts) > 50 and len(faces) > 50
    np.testing.assert_allclose(verts[:, 2].mean(), 2.0, atol=0.08)
    jverts, jfaces = jv.extract_mesh()
    np.testing.assert_allclose(verts, jverts, atol=1e-5)
    assert np.array_equal(faces, jfaces)


def test_tsdf_two_seeded_frames_match_jax():
    H, W = 48, 64
    ds = Synthetic({"dataset": "synthetic",
                    "synthetic": {"n_frames": 6, "seed": 2,
                                  "motion_scale": 5.0},
                    "cam": dict(H=H, W=W, fx=40.0, fy=40.0, cx=31.5, cy=23.5,
                                H_out=H, W_out=W)})
    intr = tuple(ds.get_intrinsic().tolist())
    frames = []
    for i in (0, 5):
        _, color, depth, c2w = ds[i]
        frames.append((depth, color, np.linalg.inv(c2w).astype(np.float32),
                       intr))
    # max_dim forces the voxel-size rescale; trunc < voxel the 4-voxel trunc
    jv, tv = _both(([-2.5, -2.0, 0.5], [2.5, 2.0, 4.0]), voxel=0.01,
                   trunc=0.04, max_dim=40)
    assert tuple(tv.tsdf.shape) == tuple(jv.tsdf.shape)
    assert max(tv.tsdf.shape) == 40 and tv.trunc == jv.trunc == 4 * tv.voxel
    for f in frames:
        jv.integrate(*f)
        tv.integrate(*f)
    skip = _near_rounding_boundary(tv, frames)
    assert skip.sum() <= 1e-2 * skip.size
    (jt, jw, jc), (tt, tw, tc) = _grids(jv, tv)
    assert (tw > 1).sum() > 1000                # both frames saw real volume
    keep = ~skip
    np.testing.assert_allclose(tt[keep], jt[keep], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw[keep], jw[keep], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc[keep], jc[keep], atol=1e-5, rtol=0)
    # and hardly any of the voxels left out differ at all
    assert (np.abs(tt - jt) > 1e-5).sum() <= 8


def test_tsdf_slabs_do_not_change_the_result(monkeypatch):
    H, W = 24, 32
    rng = np.random.RandomState(0)
    depth = (1.5 + rng.rand(H, W)).astype(np.float32)
    color = rng.rand(H, W, 3).astype(np.float32)
    args = (depth, color, np.eye(4, dtype=np.float32),
            (30.0, 30.0, 15.5, 11.5))
    bounds = ([-1.0, -0.8, 1.0], [1.0, 0.8, 3.0])
    whole = tmesh.TSDFVolume(*bounds, voxel=0.08, trunc=0.3, device="cpu")
    whole.integrate(*args)
    monkeypatch.setattr(tmesh, "SLAB_VOXELS", 3 * 21 * 26 + 5)
    parts = tmesh.TSDFVolume(*bounds, voxel=0.08, trunc=0.3, device="cpu")
    assert parts.tsdf.shape[0] > 6              # several slabs, a ragged last
    parts.integrate(*args)
    assert (whole.weight > 0).any()
    for name in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(whole, name), getattr(parts, name)), name


def test_marching_tetrahedra_sphere_and_jax_equality():
    n = 40
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    vol = np.sqrt(((g - c) ** 2).sum(0)) - 12.0
    vol[:4] = np.nan                            # unobserved cells
    verts, faces = tmesh.marching_cubes(vol, 0.0)
    assert len(verts) > 100 and len(faces) > 100
    r = np.linalg.norm(verts - c, axis=1)
    np.testing.assert_allclose(r.mean(), 12.0, atol=0.2)
    assert r.std() < 0.3
    jverts, jfaces = jmesh.marching_cubes(vol, 0.0)
    assert np.array_equal(verts, jverts) and np.array_equal(faces, jfaces)
    empty = tmesh.marching_cubes(np.full((4, 4, 4), np.nan), 0.0)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_clean_mesh_drops_small_components():
    n = 24
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    big = np.sqrt(((g - 9.0) ** 2).sum(0)) - 6.0
    small = np.sqrt(((g - 20.0) ** 2).sum(0)) - 1.2
    verts, faces = tmesh.marching_cubes(np.minimum(big, small), 0.0)
    v2, f2, _ = tmesh.clean_mesh(verts, faces, min_len=100)
    assert 0 < len(v2) < len(verts) and 0 < len(f2) < len(faces)
    assert f2.max() == len(v2) - 1
    assert np.linalg.norm(v2 - 9.0, axis=1).max() < 7.0
    jv2, jf2, _ = jmesh.clean_mesh(verts, faces, min_len=100)
    assert np.array_equal(v2, jv2) and np.array_equal(f2, jf2)


def test_fscore_sensitivity():
    rng = np.random.RandomState(2)
    verts = rng.rand(500, 3).astype(np.float32)
    faces = np.zeros((0, 3), int)
    same = tmesh.run_evaluation(verts, faces, verts, faces, icp=False,
                                n_samples=500)
    assert same["fscore"] > 0.99
    far = tmesh.run_evaluation(verts + 1.0, faces, verts, faces, icp=False,
                               n_samples=500)
    assert far["fscore"] < 0.2
    assert same == jmesh.run_evaluation(verts, faces, verts, faces, icp=False,
                                        n_samples=500)


def test_icp_recovers_a_small_motion():
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(3)
    dst = rng.rand(2000, 3)
    R = Rotation.from_rotvec([0.02, -0.03, 0.01]).as_matrix()
    src = (dst - 0.01) @ R
    Re, te = tmesh.icp_align(src, dst)
    assert np.abs(src @ Re.T + te - dst).max() < 5e-3


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
def test_mesh_ply_roundtrip(tmp_path, fmt):
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 2.5]],
                       np.float32)
    faces = np.asarray([[0, 1, 2], [1, 2, 3]])
    p = str(tmp_path / "m.ply")
    if fmt == "binary":
        tmesh.save_mesh_ply(p, verts, faces)
    else:
        with open(p, "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex 4\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "element face 2\n"
                    "property list uchar int vertex_indices\nend_header\n")
            f.writelines(f"{x} {y} {z}\n" for x, y, z in verts)
            f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)
    v, f = tmesh.load_mesh_ply(p)
    np.testing.assert_allclose(v, verts)
    np.testing.assert_array_equal(f, faces)
    jv, jf = jmesh.load_mesh_ply(p)             # either package reads it
    assert np.array_equal(v, jv) and np.array_equal(f, jf)


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_gaussian_ply_roundtrip(tmp_path, sh_degree):
    g = torch.Generator().manual_seed(0)
    st = G.make_state(64, sh_degree=sh_degree, device="cpu")
    n = 37
    for name in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        t = getattr(st, name)
        t[:n] = torch.randn(t[:n].shape, generator=g)
    st.alive[:n] = True
    st.alive[5] = False                         # a dead slot is not saved
    path = str(tmp_path / "g.ply")
    G.save_ply(st, path)
    back = G.load_ply(path, device="cpu")
    assert back.capacity == 1024 and int(back.alive.sum()) == n - 1
    assert back.f_rest.shape[1:] == st.f_rest.shape[1:]
    alive = st.alive
    for name in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        assert torch.equal(getattr(back, name)[:n - 1],
                           getattr(st, name)[alive]), name
    assert not back.alive[n - 1:].any() and (back.kf_id[:n - 1] == 0).all()
    assert G.load_ply(path, capacity=128, device="cpu").capacity == 128
    # the JAX package reads the same file to the same values
    from splatslam_tpu.mapping.gaussians import load_ply as jload
    jst = jload(path)
    for name in ("xyz", "f_rest", "rotation"):
        assert np.array_equal(np.asarray(getattr(jst, name))[:n - 1],
                              getattr(back, name)[:n - 1].numpy()), name


def test_full_traj_eval_plots(tmp_path):
    """plot_trajectory's second caller, with a stand-in trajectory filler."""
    from splatslam_tpu_torch.ops import lie
    ds = Synthetic({"dataset": "synthetic",
                    "synthetic": {"n_frames": 6, "motion_scale": 5.0},
                    "cam": dict(H=8, W=8, fx=8.0, fy=8.0, cx=3.5, cy=3.5,
                                H_out=8, W_out=8)})
    filler = lambda stream: np.stack([
        lie.from_matrix_np(np.linalg.inv(stream.get_gt_pose(i)))
        for i in range(len(stream))])
    c2w, stats = eval_traj.full_traj_eval(filler, str(tmp_path), "full_traj",
                                          ds)
    assert c2w.shape == (6, 4, 4) and stats["rmse"] < 1e-5
    assert os.path.getsize(tmp_path / "full_traj.png") > 1000
    eval_traj.full_traj_eval(filler, str(tmp_path / "quiet"), "full_traj",
                             ds, plot=False)
    assert os.listdir(tmp_path / "quiet") == ["metrics_full_traj.txt"]


def _artefact_cfg(out_dir):
    from splatslam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    cfg.pop("inherit_from", None)
    cfg.update(max_frames=12, verbose=False, eval_full_traj=False,
               eval_plots=True, scene="tiny")
    cfg["synthetic"]["n_frames"] = 12
    cfg["cam"].update(H=96, W=128, fx=80.0, fy=80.0, cx=63.5, cy=47.5,
                      H_out=96, W_out=128)
    cfg["data"]["output"] = str(out_dir)
    cfg["meshing"]["mesh"] = True
    m = cfg["mapping"]
    m.update(capacity=4096, raster_K=32, final_refine_iters=24,
             pcd_downsample=8, pcd_downsample_init=4, online_plotting=True,
             eval_before_final_ba=True)
    m["Training"].update(init_itr_num=40, init_gaussian_update=20,
                         init_gaussian_reset=1000, mapping_itr_num=10,
                         window_size=4)
    tr = cfg["tracking"]
    tr.update(buffer=16, pretrained="")
    tr["motion_filter"]["thresh"] = 0.4
    tr["frontend"].update(keyframe_thresh=0.25, window=8)
    return cfg


def test_tiny_run_writes_every_artefact(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    from splatslam_tpu_torch.slam import SLAM
    from splatslam_tpu_torch.utils.eval_render import eval_mesh
    slam = SLAM(_artefact_cfg(tmp_path), device="cpu")
    res = slam.run()
    save = tmp_path / "tiny"
    n_kf = sum(slam.mapper.is_kf.values())
    assert n_kf >= 2        # mapping starts at the fifth keyframe of six
    # mesh
    assert res["mesh"]["n_faces"] > 0 and res["mesh"]["n_verts"] > 0
    verts, faces = tmesh.load_mesh_ply(str(save / "mesh.ply"))
    assert len(faces) == res["mesh"]["n_faces"] and faces.max() < len(verts)
    assert "mesh_eval" in res["timers"]
    # the mesh lies where the scene is, 1.5-3.5 m in front of the cameras
    # (the map is in the tracker's units, global_scale metres each)
    assert 1.0 < np.median(verts[:, 2]) * slam.global_scale < 4.0
    # panels, gif, trajectory figures, online plots
    for it in ("after_refine", "before_refine"):
        plots = os.listdir(save / f"plots_{it}")
        assert sum(p.endswith(".png") for p in plots) == n_kf, it
        assert "renders.gif" in plots
        assert os.path.exists(save / "rendering" / it / "final_result.json")
    from PIL import Image
    with Image.open(save / "plots_after_refine" / "renders.gif") as im:
        assert im.n_frames == n_kf and im.size == (128, 96)
    for name in ("kf_traj.png", "kf_traj_before_ba.png",
                 "metrics_kf_traj_before_ba.txt", "kf_traj_aligned.npy"):
        assert os.path.exists(save / "traj" / name), name
    assert os.path.exists(save / "video_before_ba.npz")
    # one per keyframe mapped after the initialisation
    assert len(os.listdir(save / "online_plots")) == n_kf - 1
    # a ground-truth mesh (in metres) adds the F-score: the mesh against
    # its own metric copy, moved by 2 mm (ICP's 90th-percentile gate keeps
    # no pair at all when every distance is exactly zero)
    gt = str(tmp_path / "gt.ply")
    tmesh.save_mesh_ply(gt, verts * slam.global_scale + 0.002, faces)
    r = eval_mesh(slam.mapper, str(tmp_path / "again"),
                  global_scale=slam.global_scale, gt_mesh_path=gt)
    assert r["n_faces"] == res["mesh"]["n_faces"] and r["fscore"] > 0.99
