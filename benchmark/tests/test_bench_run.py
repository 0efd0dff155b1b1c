"""Whole runs of the harness on the CPU at a tiny size (tiny.shrink): the
reference agrees with the program, the check turns false under each fault
a cell can have, the frozen FLOP model against the program's counters,
and a cell, a configuration, a traffic mix and a metric added as files
are found and run."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, probes
from benchmark.tests import tiny

ROOT = harness.ROOT


def run(cell, seconds=3.0, traced=False, **kw):
    return harness.run(cell, 7, seconds, traced, "cpu", overrides=tiny.shrink,
                       **kw)


@pytest.fixture
def f32_net(monkeypatch):
    monkeypatch.setenv("SPLATSLAM_F32_NET", "1")


def values(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def test_oracle_cell_agrees_with_the_reference():
    r = run("replica_scale.orbit")
    assert r["correct"]
    assert set(values(r)) == {"dba_gap", "render_gap", "step_gap",
                              "dspo_gap"}
    # the same plain code on the same device: equal to rounding
    v = values(r)
    assert max(v["render_gap"], v["step_gap"]) <= 1e-6, v
    assert v["dba_gap"] <= 1e-4, v     # float32 against float64
    m = r["metrics"]
    assert set(m) == {"fps", "frame_ms_p90", "setup_s"}
    assert m["fps"]["value"] > 0 and r["attempted"] > 0


def test_learned_cell_agrees_with_the_reference(f32_net):
    r = run("learned.orbit")
    v = values(r)
    assert set(v) == {"scan_gap", "update_gap", "dba_gap", "render_gap",
                      "step_gap", "dspo_gap"}
    assert r["correct"], v
    # float32 network on both sides; the program keeps features in bf16
    assert v["update_gap"] <= 2e-3 and v["scan_gap"] <= 1e-5, v
    assert max(v["render_gap"], v["step_gap"]) <= 1e-6 and v["dba_gap"] <= 1e-4, v


def test_the_control_reads_incorrect():
    """The reference one precision below the configuration's, in the
    program's place, is judged against the cell's limits and fails."""
    r = run("replica_scale.orbit", control=True)
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, r["control"]
    assert list(r)[-1] == "checks"
    w = r["work"]
    assert w["frames"] == r["attempted"] and w["keyframes"] >= 0


def _unchanged_dba(orig):
    def f(poses, disps, *a, **kw):
        return poses, disps
    return f


def _no_adam(orig):
    def f(st, grads, lrs, step, *a, **kw):
        return st
    return f


def _half_batch(orig):
    # the loss over the first half of the cameras, the rest given its mean
    def f(image, depth, gt_image, gt_depth, **kw):
        per_cam = orig(image, depth, gt_image, gt_depth, **kw)
        h = max(1, per_cam.shape[0] // 2)
        return torch.cat([per_cam[:h],
                          per_cam[:h].mean().expand(per_cam.shape[0] - h)])
    return f


def _unchanged_scale_shift(orig):
    def f(poses, disps, intrinsics, target, weight, eta, mono_disps, scales,
          shifts, *a, **kw):
        return disps, scales, shifts
    return f


def _altered_render(orig):
    def f(*a, **kw):
        out = orig(*a, **kw)
        out.color = out.color.clone()
        out.color[..., 0, 0, :] += 0.5
        return out
    return f


FAULTS = {
    "dba_state_unchanged": ("splatslam_tpu_torch.ops.ba", "dba",
                            _unchanged_dba, "dba_gap"),
    "map_state_unchanged": ("splatslam_tpu_torch.mapping.gaussians",
                            "adam_step", _no_adam, "step_gap"),
    "dspo_state_unchanged": ("splatslam_tpu_torch.ops.ba",
                             "_scale_shift_iteration",
                             _unchanged_scale_shift, "dspo_gap"),
    "half_batch": ("splatslam_tpu_torch.mapping.mapper", "mapping_loss",
                   _half_batch, "step_gap"),
    "answer_altered": ("splatslam_tpu_torch.ops.rasterizer",
                       "rasterize_batch", _altered_render, "render_gap"),
}


def with_fault(fault, monkeypatch):
    """A run whose timed path is broken from the moment the check is
    armed (mid-window) to the end of the loop."""
    import importlib
    mod, attr, make, _ = FAULTS[fault]
    arm = probes.Capture.arm

    def arm_and_break(self, p):
        # the fault goes in underneath the capture's wrappers
        p.put(importlib.import_module(mod), attr, make)
        arm(self, p)

    monkeypatch.setattr(probes.Capture, "arm", arm_and_break)
    return run("replica_scale.orbit")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_reads_incorrect(fault, monkeypatch):
    number = FAULTS[fault][3]
    r = with_fault(fault, monkeypatch)
    assert not r["correct"]
    row = r["checks"][number]
    assert row["value"] > row["limit"], row


@pytest.mark.parametrize("cell", ["replica_scale.orbit", "learned.orbit"])
def test_flop_model_against_the_programs_counters(cell, f32_net):
    """Counted over a whole run. Tracking: the program counts the oracle
    targets and the update operator once per round over active and
    inactive edges, the frozen model each call over the edges it is
    handed, plus the keyframe-cull distances the program leaves out.
    Mapping: live Gaussians where the program multiplies by the padded
    capacity, so the model's count is the smaller."""
    from splatslam_tpu_torch.slam import SLAM
    spec = harness.load_cell(cell)
    cfg = harness.slam_config(spec, "/tmp/unused")
    tiny.shrink(cfg, spec)
    frames = harness.scene.render_frames(cfg, 7, 40,
                                         spec["traffic"]["motion_scale"])
    slam = SLAM(cfg, device="cpu",
                stream=harness.scene.Stream(cfg, *frames))
    c = probes.Counters(cfg["cam"]["H_out"], cfg["cam"]["W_out"],
                        cfg["mapping"]["raster_K"])
    patches = probes.Patches()
    c.install(patches)
    c.active = True

    def stop_at_end(i, *_):
        if i >= 38:
            raise harness._Stop

    try:
        slam.run(on_frame=stop_at_end)
    except harness._Stop:
        pass
    finally:
        patches.remove()
    ours, _ = c.read()
    v = slam.video
    tracking = ours["tracking"] / v.flops_tracking
    mapping = ours["mapping"] / v.flops_mapping
    print(f"{cell}: frozen model / program: tracking {tracking:.4f}, "
          f"mapping {mapping:.4f}")
    assert 0.5 <= tracking <= 1.5
    assert 0.0 < mapping < 1.0


# a checked stage added as a file: the mono prior's scale and shift fit
# (ops/ba.align_scale_and_shift), worked out again in float64
ADDED_STAGE = """
import torch
from splatslam_tpu_torch.ops import ba as ba_ops
from ..check import _bf16, _rel
from ..probes import clone

NUMBERS = ("added_gap",)


def arm(slot, p):
    def wrap(orig):
        def f(prediction, target, weights):
            out = orig(prediction, target, weights)
            if not slot.full:
                slot.put(dict(args=clone((prediction, target, weights)),
                              out=clone(out)))
            return out
        return f
    p.put(ba_ops, "align_scale_and_shift", wrap)


def fit(pred, tgt, w):
    s = lambda x: x.sum((-2, -1))
    a00, a01, a11 = s(w * pred * pred), s(w * pred), s(w)
    b0, b1 = s(w * pred * tgt), s(w * tgt)
    det = a00 * a11 - a01 * a01
    ok = det > 0
    det = torch.where(ok, det, torch.ones_like(det))
    return torch.stack([torch.where(ok, (a11 * b0 - a01 * b1) / det, 0 * det),
                        torch.where(ok, (a00 * b1 - a01 * b0) / det, 0 * det)])


def reference(ctx, cap):
    pred, tgt, w = cap["args"]
    return fit(pred.double(), tgt.double(), w.double())


def gaps(cap, ref):
    return {"added_gap": _rel(torch.stack(cap["out"][:2]), ref)}


def control(ctx, cap, ref):
    pred, tgt, w = _bf16(cap["args"])
    return {"added_gap": _rel(fit(pred, tgt, w.float()), ref)}
"""

# a FLOP term added as a file, under a kind of its own: the oracle's flow
# of every frame after the first, so every window counts some
ADDED_TERMS = """
from splatslam_tpu_torch.tracking import motion_filter as mf_mod
from . import Term


def oracle_flow(orig, c, add):
    def f(self, *a, **kw):
        add(1e3 * c.h8w8)
        return orig(self, *a, **kw)
    return f


TERMS = [Term(mf_mod.MotionFilter, "_oracle_flow", "added_kind",
              oracle_flow)]
"""


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    """A cell, its configuration, traffic mix and workload file, a
    per-layer metric, a checked stage with a limit, and a FLOP term, each
    added as a new file to a copy of the benchmark (no file of it edited),
    are found and run: the stage's number in `checks` and `correct`, the
    term's count in the record's `flops`."""
    work = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), work / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), work)
    os.symlink(os.path.join(ROOT, "pretrained"), work / "pretrained")
    b = json.loads((work / "BENCHMARK.json").read_text())
    conf = json.loads((work / "benchmark/configs/replica_scale.json")
                      .read_text())
    conf["slam"]["mapping"]["Training"]["mapping_itr_num"] = 3
    (work / "benchmark/configs/added_config.json").write_text(
        json.dumps(conf))
    (work / "benchmark/traffic/added_mix.json").write_text(
        json.dumps({"motion_scale": 4.0}))
    wl = json.loads((work / "benchmark/workloads/replica_scale.orbit.json")
                    .read_text())
    wl["limits"]["added_gap"] = 1e-3
    (work / "benchmark/workloads/added.cell.json").write_text(
        json.dumps(wl))
    (work / "benchmark/stages/added_stage.py").write_text(ADDED_STAGE)
    (work / "benchmark/flop_terms/added_terms.py").write_text(ADDED_TERMS)
    metrics = {
        "added_metric": "1e3 * rec['part']['timers']['seconds']"
                        ".get('data', 0.0) / rec['part']['frames']",
        "added_flops": "rec['flops_by_kind']['added_kind']",
        "added_share": "rec['flops_by_kind']['added_kind'] / rec['flops']",
    }
    for name, expr in metrics.items():
        (work / f"benchmark/metrics/{name}.py").write_text(
            f"def read(rec):\n    return {expr}\n")
        b["per_layer"].append(dict(name=name, unit="ms",
                                   better="lower", source="program_span",
                                   layer="loop", moves="fps"))
    b["configs"].append(dict(b["configs"][1], name="added_config",
                             file="benchmark/configs/added_config.json"))
    b["workloads"].append(dict(name="added.cell", config="added_config",
                               traffic="added_mix", chips=1, why="a test"))
    (work / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "r = harness.run('added.cell', 7, 2.0, True, 'cpu',"
        " root=harness.ROOT, overrides=tiny.shrink)\n"
        "print(json.dumps({'root': harness.ROOT, 'metrics': r['metrics'],"
        " 'correct': r['correct'], 'checks': r['checks']}))\n")
    env = dict(os.environ, PYTHONPATH=f"{work}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=work, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["root"] == str(work)
    assert res["correct"], res["checks"]
    row = res["checks"]["added_gap"]
    assert row["value"] is not None and row["value"] <= row["limit"], row
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["added_metric"] >= 0
    assert m["added_flops"] > 0 and 0 < m["added_share"] <= 1, m


def test_each_run_reads_its_own_priors(tmp_path, monkeypatch):
    """Two runs of one cell in one TMPDIR at two seeds: each run's mono
    prior of a frame is its own scene's (the oracle prior of the depth
    that seed renders), not the one an earlier run saved, and each run's
    output directory is gone when it returns."""
    from splatslam_tpu_torch import mono_prior
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    served = {}
    call = mono_prior.MonoDepthProvider.__call__

    def spy(self, idx):
        d = call(self, idx)
        served.setdefault(int(idx), d)
        return d

    monkeypatch.setattr(mono_prior.MonoDepthProvider, "__call__", spy)
    spec = harness.load_cell("replica_scale.orbit")
    cfg = harness.slam_config(spec, "unused")
    tiny.shrink(cfg, spec)
    for seed in (7, 2 ** 31 + 11):
        served.clear()
        harness.run("replica_scale.orbit", seed, 2.0, False, "cpu",
                    overrides=tiny.shrink)
        assert os.listdir(tmp_path / "benchmark") == []
        _, depths, _ = harness.scene.render_frames(
            cfg, seed, max(served) + 1, spec["traffic"]["motion_scale"])
        assert served
        for idx, d in served.items():
            z = depths[idx]
            mono = np.where(z > 1e-6, 0.5 / np.maximum(z, 1e-6) + 0.2, 0.0)
            own = np.where(mono > 1e-6, 1.0 / np.maximum(mono, 1e-6), 0.0)
            assert np.array_equal(d, own), (seed, idx)
