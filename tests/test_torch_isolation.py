"""The port stands alone: importing every module of splatslam_tpu_torch
loads neither jax nor the JAX package, and its entry point and every public
constructor refuse to run on a machine without a GPU unless the caller
names the device."""

import os
import subprocess
import sys

import pytest
import torch

from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import splatslam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [k for k in ("jax", "splatslam_tpu") if k in sys.modules]
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


def test_run_without_device_raises_when_no_gpu(monkeypatch):
    from splatslam_tpu_torch import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml")])


class _Data:
    def get_intrinsic(self):
        import numpy as np
        return np.asarray([40.0, 40.0, 32.0, 24.0], np.float32)


def _accept(cfg):
    """What SLAM builds from a config before it reads a frame, on the CPU:
    the video and the mapper, which resolves `mapping.mesh_devices`.
    Returns the mapper."""
    from splatslam_tpu_torch.mapping.mapper import Mapper
    from splatslam_tpu_torch.tracking.depth_video import DepthVideo
    return Mapper(cfg, DepthVideo(cfg, device="cpu"), _Data(), device="cpu")


def test_learned_smoke_config_is_inside_the_slice(monkeypatch):
    """The port takes the system's own main path, learned tracking."""
    monkeypatch.chdir(REPO)
    from splatslam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    assert not cfg["tracking"].get("oracle", False)
    assert _accept(cfg).devices is None


@pytest.mark.parametrize("edit,match", [
    (("mapping", "mesh_devices", 2),
     "[mapper] mesh_devices=2 requested but only 1 devices visible — "
     "running single-chip"),
    (("mapping", "mesh_devices", 4),
     "[mapper] mesh_devices=4 requested but only 1 devices visible — "
     "running single-chip"),
])
def test_configs_outside_the_slice_fail_loudly(edit, match, monkeypatch,
                                               capsys):
    """Camera-parallel mapping is accepted; with fewer devices visible than
    asked (one CPU here) the mapper says so, as the JAX mapper does, and
    runs on one device."""
    monkeypatch.chdir(REPO)
    from splatslam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    sec, key, val = edit
    cfg[sec][key] = val
    capsys.readouterr()
    mapper = _accept(cfg)
    assert match in capsys.readouterr().out
    assert mapper.devices is None


@pytest.mark.parametrize("edit", [
    ("mono_prior", "provider", "dpt"), ("mono_prior", "provider", "files"),
    ("dataset", None, "replica"), ("dataset", None, "scannet"),
    ("dataset", None, "tumrgbd"), ("mapping", "mesh_devices", 1),
    ("meshing", "mesh", True)])
def test_recorded_sequence_configs_are_inside_the_slice(edit, monkeypatch):
    monkeypatch.chdir(REPO)
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.datasets import dataset_dict
    from splatslam_tpu_torch.mono_prior import PROVIDERS
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    sec, key, val = edit
    if key is None:
        cfg[sec] = val
    else:
        cfg[sec][key] = val
    assert cfg["dataset"] in dataset_dict
    assert cfg["mono_prior"]["provider"] in PROVIDERS
    assert _accept(cfg).devices is None


def test_every_config_in_the_repository_is_inside_the_slice(monkeypatch):
    import glob
    monkeypatch.chdir(REPO)
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.datasets import dataset_dict
    from splatslam_tpu_torch.mono_prior import PROVIDERS
    paths = [p for p in glob.glob(os.path.join(REPO, "configs/*/*.yaml"))]
    assert len(paths) >= 10
    for p in paths:
        cfg = load_config(p, os.path.join(REPO, "configs/splat_slam.yaml"))
        if "dataset" not in cfg:      # a dataset's shared base file
            continue
        _accept(cfg)
        assert cfg["dataset"] in dataset_dict, p
        assert cfg["mono_prior"]["provider"] in PROVIDERS, p


def _constructors():
    """name -> callable(device) for every public constructor of the port
    that places tensors."""
    import numpy as np
    from splatslam_tpu_torch import convert
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch import mono_prior
    from splatslam_tpu_torch.mapping import camera, gaussians, mapper
    from splatslam_tpu_torch.models import dpt
    from splatslam_tpu_torch.tracking import depth_video
    from splatslam_tpu_torch.utils import mesh

    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    cfg["cam"]["H_out"], cfg["cam"]["W_out"] = 48, 64
    cfg["tracking"]["buffer"] = 4
    cfg["mapping"]["capacity"] = 256
    gs = {k: v.numpy() for k, v in vars(
        gaussians.make_state(8, device="cpu")).items()}
    # numpy has no bf16: the feature maps cross as float32
    vs = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
          for k, v in vars(
              depth_video.make_video_state(2, 16, 16, device="cpu")).items()}

    class _Data:
        def get_intrinsic(self):
            return np.asarray([40.0, 40.0, 32.0, 24.0], np.float32)

    def make_mapper(device):
        video = depth_video.DepthVideo(cfg, device="cpu")
        return mapper.Mapper(cfg, video, _Data(), device=device)

    return {
        "DepthVideo": lambda d: depth_video.DepthVideo(cfg, device=d),
        "make_video_state": lambda d: depth_video.make_video_state(
            2, 16, 16, device=d),
        "Mapper": make_mapper,
        "make_state": lambda d: gaussians.make_state(8, device=d),
        "make_camera": lambda d: camera.make_camera(
            0, np.zeros((4, 4, 3), np.float32), np.ones((4, 4), np.float32),
            np.eye(4), device=d),
        "gaussian_state_from_numpy": lambda d:
            convert.gaussian_state_from_numpy(gs, device=d),
        "video_state_from_numpy": lambda d:
            convert.video_state_from_numpy(vs, device=d),
        "load_ply": lambda d: gaussians.load_ply(_saved_ply(), device=d),
        "TSDFVolume": lambda d: mesh.TSDFVolume(
            [0, 0, 0], [1, 1, 1], voxel=0.25, device=d),
        "DPTDepthPredictor": lambda d: dpt.DPTDepthPredictor(
            "", size=32, device=d).model,
        "MonoDepthProvider_dpt": lambda d: mono_prior.MonoDepthProvider(
            {"mono_prior": {"provider": "dpt", "depth_pretrained": "",
                            "save_depths": False}}, None, "unused",
            device=d)._dpt.model,
    }


def _saved_ply():
    import tempfile
    from splatslam_tpu_torch.mapping import gaussians
    st = gaussians.make_state(8, device="cpu")
    st.alive[:3] = True
    path = os.path.join(tempfile.mkdtemp(), "g.ply")
    gaussians.save_ply(st, path)
    return path


@pytest.mark.parametrize("name", [
    "DepthVideo", "make_video_state", "Mapper", "make_state", "make_camera",
    "gaussian_state_from_numpy", "video_state_from_numpy", "load_ply",
    "TSDFVolume", "DPTDepthPredictor", "MonoDepthProvider_dpt"])
def test_constructor_defaults_to_the_gpu(name, monkeypatch):
    """device=None resolves through resolve_device: without a GPU it raises
    the CLI's error instead of building on the CPU; "cpu" is still taken."""
    import inspect
    monkeypatch.chdir(REPO)
    make = _constructors()[name]
    obj = make("cpu")
    tensors = list(obj.parameters()) if isinstance(obj, torch.nn.Module) \
        else [v for v in vars(obj).values() if torch.is_tensor(v)] or [
            v for v in vars(getattr(obj, "st", getattr(obj, "state", obj))
                            ).values() if torch.is_tensor(v)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(None)
    # and the default really is None
    from splatslam_tpu_torch import convert, mono_prior
    from splatslam_tpu_torch.mapping import camera, gaussians, mapper
    from splatslam_tpu_torch.models import dpt
    from splatslam_tpu_torch.tracking import depth_video
    from splatslam_tpu_torch.utils import mesh
    fn = {"load_ply": gaussians.load_ply,
          "TSDFVolume": mesh.TSDFVolume.__init__,
          "DPTDepthPredictor": dpt.DPTDepthPredictor.__init__,
          "MonoDepthProvider_dpt": mono_prior.MonoDepthProvider.__init__,
          "DepthVideo": depth_video.DepthVideo.__init__,
          "make_video_state": depth_video.make_video_state,
          "Mapper": mapper.Mapper.__init__,
          "make_state": gaussians.make_state,
          "make_camera": camera.make_camera,
          "gaussian_state_from_numpy": convert.gaussian_state_from_numpy,
          "video_state_from_numpy": convert.video_state_from_numpy}[name]
    assert inspect.signature(fn).parameters["device"].default is None


def _tracker_constructors():
    """name -> (callable(device), tensors(obj), function that has the
    `device` parameter or None) for the learned tracker's constructors.
    FactorGraph and PoseTrajectoryFiller have no device of their own: they
    live where their video does."""
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.models import droid_net, weights
    from splatslam_tpu_torch.tracking import (depth_video, factor_graph,
                                              trajectory_filler)
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    cfg["cam"]["H_out"], cfg["cam"]["W_out"] = 48, 64
    cfg["tracking"]["buffer"] = 4
    params = lambda m: list(m.parameters())
    net = lambda: droid_net.DroidNet(device="cpu")
    return {
        "DroidNet": (lambda d: droid_net.DroidNet(device=d), params,
                     droid_net.DroidNet.__init__),
        "load_droid_params": (
            lambda d: weights.load_droid_params(
                "pretrained/droid_dba.msgpack", device=d), params,
            weights.load_droid_params),
        "FactorGraph": (
            lambda d: factor_graph.FactorGraph(
                depth_video.DepthVideo(cfg, device=d), net()),
            lambda g: [g.target, g.weight, g.net, g.damping_maps], None),
        "PoseTrajectoryFiller": (
            lambda d: trajectory_filler.PoseTrajectoryFiller(
                net(), depth_video.DepthVideo(cfg, device=d)),
            lambda f: list(vars(f.video.state).values()), None),
    }


@pytest.mark.parametrize("name", ["DroidNet", "load_droid_params",
                                  "FactorGraph", "PoseTrajectoryFiller"])
def test_tracker_constructor_defaults_to_the_gpu(name, monkeypatch):
    import inspect
    monkeypatch.chdir(REPO)
    make, tensors, fn = _tracker_constructors()[name]
    held = tensors(make("cpu"))
    assert held and all(t.device.type == "cpu" for t in held)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(None)
    if fn is not None:
        assert inspect.signature(fn).parameters["device"].default is None


def _trainer_entry_points(tmp_path):
    """name -> (callable(device), function that has the `device` parameter
    or None) for the self-trainer's public entry points, at a tiny size."""
    from splatslam_tpu_torch import train_droid
    from splatslam_tpu_torch.models import weights
    from splatslam_tpu_torch.train import droid_trainer as T
    ckpt = str(tmp_path / "net.msgpack")
    weights.save_droid_params(weights.init_params(device="cpu"), ckpt)
    small = dict(steps=1, batch=1, H=64, W=96, iters=1, pool=1,
                 ckpt_path=None)
    return {
        "train": (lambda d: T.train(**small, device=d)[0], T.train),
        "train_dba": (lambda d: T.train_dba(
            **dict(small, N=3), init_ckpt=ckpt, device=d)[0], T.train_dba),
        "init_params": (lambda d: weights.init_params(device=d),
                        weights.init_params),
        "load_selftrained": (lambda d: weights.load_selftrained(ckpt,
                                                                device=d),
                             weights.load_selftrained),
        "train_droid": (lambda d: train_droid.main(
            ["--steps", "1", "--batch", "1", "--pool", "1", "--buckets",
             "small", "--out", str(tmp_path / "cli.msgpack")]
            + (["--device", d] if d else [])), None),
    }


@pytest.mark.parametrize("name", ["train", "train_dba", "init_params",
                                  "load_selftrained", "train_droid"])
def test_trainer_entry_point_defaults_to_the_gpu(name, tmp_path,
                                                 monkeypatch):
    """The trainer, its network constructors and its CLI run on the CPU
    only when asked; without a GPU and without a device they raise."""
    import inspect
    make, fn = _trainer_entry_points(tmp_path)[name]
    out = make("cpu")
    if isinstance(out, torch.nn.Module):
        assert all(p.device.type == "cpu" and p.requires_grad
                   for p in out.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(None)
    if fn is not None:
        assert inspect.signature(fn).parameters["device"].default is None
