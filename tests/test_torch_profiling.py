"""The profiler trace of the main loop: `profiling.trace_dir` and the CLI's
`--profile DIR` write a torch.profiler Chrome trace of SLAM's loop (the
frames, not the final BA and evaluations) to DIR/trace.json, naming the
timed phases and the operators under them; with the key unset nothing is
traced. The counterpart of the JAX package's device_trace
(splatslam_tpu/utils/profiling.py:74-82, slam.py:72,183)."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from splatslam_tpu_torch.utils import profiling
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_PHASES = ("data", "motion_filter", "frontend")


def _cfg(out_dir, **profiling_keys):
    """test_torch_slam's shrunk oracle config, tracking only, 8 frames."""
    from test_torch_slam import _cfg as slam_cfg
    cfg = slam_cfg(out_dir)
    cfg.update(max_frames=8, only_tracking=True)
    cfg["synthetic"]["n_frames"] = 8
    if profiling_keys:
        cfg["profiling"] = dict(profiling_keys)
    return cfg


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events}


def test_trace_dir_writes_a_trace_of_the_loop(tmp_path, monkeypatch):
    from splatslam_tpu_torch.slam import SLAM
    monkeypatch.chdir(REPO)
    trace_dir = tmp_path / "trace"
    slam = SLAM(_cfg(tmp_path / "out", trace_dir=str(trace_dir)),
                device="cpu")
    res = slam.run()
    assert np.isfinite(res["ate_rmse"])
    names = _trace_names(trace_dir / profiling.TRACE_FILE)
    for phase in LOOP_PHASES:
        assert phase in names, phase
    assert any(n.startswith("aten::") for n in names)
    # the region is the loop: the final BA and the evaluations are outside
    assert "final_ba" in res["timers"] and "final_ba" not in names
    assert "kf_traj_eval" not in names


def test_profile_flag_writes_the_trace_and_prints_the_timers(
        tmp_path, monkeypatch, capsys):
    from splatslam_tpu_torch import run
    monkeypatch.chdir(REPO)
    cfg = _cfg(tmp_path / "out")
    cfg["verbose"] = True
    path = tmp_path / "tiny.yaml"
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    trace_dir = tmp_path / "prof"
    res = run.main([str(path), "--profile", str(trace_dir), "--device",
                    "cpu"])
    out = capsys.readouterr().out
    assert "phase timing:" in out
    assert "total_s" in out and "frontend" in out
    assert np.isfinite(res["ate_rmse"])
    names = _trace_names(trace_dir / profiling.TRACE_FILE)
    assert all(p in names for p in LOOP_PHASES)
    with open(tmp_path / "out" / "tiny" / "config.yaml") as f:
        saved = yaml.safe_load(f)
    assert saved["profiling"] == {"trace_dir": str(trace_dir),
                                  "timers": True}


def test_no_trace_without_the_key(tmp_path, monkeypatch):
    from splatslam_tpu_torch.slam import SLAM
    monkeypatch.chdir(REPO)

    def refuse(*a, **kw):
        raise AssertionError("torch.profiler.profile was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    slam = SLAM(_cfg(tmp_path / "out"), device="cpu")
    assert slam.trace_dir is None
    assert np.isfinite(slam.run()["ate_rmse"])
    written = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert profiling.TRACE_FILE not in written
    # and the context itself is a no-op
    with profiling.device_trace(None):
        pass
    with profiling.device_trace(""):
        pass


@pytest.mark.parametrize("device,cuda", [("cpu", False), ("cuda", True)])
def test_trace_activities_follow_the_device(device, cuda, tmp_path,
                                            monkeypatch):
    """CPU activity always; CUDA activity only for a CUDA run."""
    seen = {}

    class Fake:
        def __init__(self, activities):
            seen["acts"] = activities

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            seen["path"] = path

    monkeypatch.setattr(torch.profiler, "profile", Fake)
    with profiling.device_trace(str(tmp_path / "t"), torch.device(device)):
        pass
    acts = torch.profiler.ProfilerActivity
    assert seen["acts"] == [acts.CPU] + ([acts.CUDA] if cuda else [])
    assert seen["path"] == str(tmp_path / "t" / profiling.TRACE_FILE)
