"""Mono-prior providers: the port's MonoDepthProvider behaves as the JAX
package's, scenario by scenario (every scenario runs against both), and a
`dpt` run followed by a `files` run on its saved depths goes through the
port's CLI on the CPU.

The network itself is held against the JAX network in
tests/test_torch_dpt.py; here the `dpt` provider's predictor is replaced by
a counting stand-in wherever only the caching logic is under test.
"""

import os

import numpy as np
import pytest

from splatslam_tpu import mono_prior as jmp
from splatslam_tpu_torch import mono_prior as tmp_
from splatslam_tpu_torch.datasets import Synthetic
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 32


class _Counting:
    """A dataset that counts its reads."""

    def __init__(self):
        self.ds = Synthetic({
            "dataset": "synthetic", "synthetic": {"n_frames": 4, "seed": 1},
            "cam": dict(H=H, W=W, fx=20.0, fy=20.0, cx=15.5, cy=11.5,
                        H_out=H, W_out=W)})
        self.reads = 0

    def __getitem__(self, i):
        self.reads += 1
        return self.ds[i]


class _StubPredictor:
    """Stands in for DPTDepthPredictor: depth = mean colour + 1."""
    calls = 0

    def __init__(self, ckpt_path=None, size=512, device=None):
        pass

    def __call__(self, image):
        type(self).calls += 1
        return (np.asarray(image).mean(-1) + 1.0).astype(np.float32)


@pytest.fixture(params=["jax", "port"])
def make(request, monkeypatch):
    """provider factory of one of the two packages: make(kind, dataset,
    save_dir, **mono_prior keys)."""
    _StubPredictor.calls = 0
    if request.param == "jax":
        from splatslam_tpu.models import dpt
        monkeypatch.setattr(dpt, "DPTDepthPredictor", _StubPredictor)
        return lambda kind, ds, out, **kw: jmp.MonoDepthProvider(
            {"dataset": "synthetic", "mono_prior": dict(provider=kind, **kw)},
            ds, str(out))
    from splatslam_tpu_torch.models import dpt
    monkeypatch.setattr(dpt, "DPTDepthPredictor", _StubPredictor)
    return lambda kind, ds, out, **kw: tmp_.MonoDepthProvider(
        {"dataset": "synthetic", "mono_prior": dict(provider=kind, **kw)},
        ds, str(out), device="cpu")


def _npy(out, idx):
    return os.path.join(str(out), "mono_priors", "depths", f"{idx:05d}.npy")


def test_files_reads_what_oracle_wrote(make, tmp_path):
    ds = _Counting()
    d1 = make("oracle", ds, tmp_path)(1)
    assert d1.shape == (H, W) and os.path.exists(_npy(tmp_path, 1))
    files = make("files", ds, tmp_path)
    reads = ds.reads
    assert np.array_equal(files(1), d1)
    assert ds.reads == reads                    # from disk, not the dataset
    with pytest.raises(FileNotFoundError, match="00002.npy"):
        files(2)


def test_second_run_rereads_the_saved_depths(make, tmp_path):
    """A run in a folder that holds this provider's maps takes them up."""
    ds = _Counting()
    make("oracle", ds, tmp_path)(0)
    np.save(_npy(tmp_path, 0), np.full((H, W), 7.0, np.float32))
    reads = ds.reads
    again = make("oracle", ds, tmp_path)
    assert (again(0) == 7.0).all() and ds.reads == reads
    assert again(3).shape == (H, W) and ds.reads == reads + 1


def test_marker_keeps_dpt_from_oracles_files(make, tmp_path):
    ds = _Counting()
    want_oracle = make("oracle", ds, tmp_path)(0)
    marker = os.path.join(str(tmp_path), "mono_priors", "depths", ".provider")
    with open(marker) as f:
        assert f.read() == "oracle"
    dpt = make("dpt", ds, tmp_path, depth_pretrained="")
    with open(marker) as f:
        assert f.read() == "dpt"
    d = dpt(0)
    assert _StubPredictor.calls == 1
    assert not np.array_equal(d, want_oracle)
    assert np.array_equal(np.load(_npy(tmp_path, 0)), d)    # overwritten
    dpt(0)
    assert _StubPredictor.calls == 1                        # memory cache
    # the next dpt run finds its own marker and reads the file
    assert np.array_equal(make("dpt", ds, tmp_path, depth_pretrained="")(0), d)
    assert _StubPredictor.calls == 1


def test_save_depths_off_writes_nothing_and_none_gives_none(make, tmp_path):
    ds = _Counting()
    assert make("oracle", ds, tmp_path, save_depths=False)(0) is not None
    assert not os.path.exists(os.path.join(str(tmp_path), "mono_priors"))
    assert make("none", ds, tmp_path)(0) is None


def test_oracle_values_equal_between_packages(tmp_path):
    ds = _Counting()
    a = jmp.MonoDepthProvider({"dataset": "synthetic"}, ds,
                              str(tmp_path / "a"))(2)
    b = tmp_.MonoDepthProvider({"dataset": "synthetic"}, ds,
                               str(tmp_path / "b"), device="cpu")(2)
    assert np.array_equal(a, b)


def test_unknown_provider_and_missing_checkpoint_raise(tmp_path):
    ds = _Counting()
    with pytest.raises(ValueError, match="midas"):
        tmp_.MonoDepthProvider({"mono_prior": {"provider": "midas"}}, ds,
                               str(tmp_path), device="cpu")
    # the default path of configs/splat_slam.yaml is not in the repository
    with pytest.raises(FileNotFoundError, match="omnidata checkpoint"):
        tmp_.MonoDepthProvider({"mono_prior": {"provider": "dpt"}}, ds,
                               str(tmp_path), device="cpu")


def _tiny_cfg(out_dir, provider):
    from splatslam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    cfg.pop("inherit_from", None)
    cfg.update(max_frames=12, verbose=False, eval_full_traj=False,
               eval_plots=False, scene="prior")
    cfg["synthetic"]["n_frames"] = 12
    cfg["cam"].update(H=96, W=128, fx=80.0, fy=80.0, cx=63.5, cy=47.5,
                      H_out=96, W_out=128)
    cfg["data"]["output"] = str(out_dir)
    cfg["meshing"]["mesh"] = False
    cfg["mono_prior"].update(provider=provider, depth_pretrained="")
    m = cfg["mapping"]
    m.update(capacity=2048, raster_K=32, final_refine_iters=8,
             pcd_downsample=8, pcd_downsample_init=4)
    m["Training"].update(init_itr_num=16, init_gaussian_update=8,
                         init_gaussian_reset=1000, mapping_itr_num=4,
                         window_size=4)
    tr = cfg["tracking"]
    tr.update(buffer=16, pretrained="")
    tr["motion_filter"]["thresh"] = 0.4
    tr["frontend"].update(keyframe_thresh=0.25, window=8)
    return cfg


def test_cli_runs_dpt_then_files_on_its_depths(tmp_path, monkeypatch):
    """`provider: dpt` with seeded full-width weights through the port's CLI
    at --device cpu, then `provider: files` on the depths it saved: the same
    priors, so the same keyframes and the same trajectory."""
    import yaml
    from splatslam_tpu_torch import run
    monkeypatch.chdir(REPO)
    results = {}
    for provider in ("dpt", "files"):
        path = tmp_path / f"{provider}.yaml"
        with open(path, "w") as f:
            yaml.dump(_tiny_cfg(tmp_path / "out", provider), f)
        results[provider] = run.main([str(path), "--device", "cpu"])
    depths = tmp_path / "out" / "prior" / "mono_priors" / "depths"
    saved = sorted(p for p in os.listdir(depths) if p.endswith(".npy"))
    with open(depths / ".provider") as f:
        assert f.read() == "dpt"                # `files` leaves the marker
    a, b = results["dpt"], results["files"]
    assert len(saved) >= a["n_keyframes"] >= 5
    d = np.load(depths / saved[0])
    assert d.shape == (96, 128) and d.dtype == np.float32
    assert np.isfinite(d).all() and d.std() > 0
    assert b["n_keyframes"] == a["n_keyframes"]
    assert a["ate_rmse"] == pytest.approx(b["ate_rmse"], abs=1e-9)
    for r in (a, b):
        assert np.isfinite([r["ate_rmse"], r["psnr"], r["depth_l1"]]).all()
