"""The profiler trace of the main loop: `profiling.trace_dir` and the CLI's
`--profile DIR` write a torch.profiler Chrome trace of SLAM's loop (the
frames, not the final BA and evaluations) to DIR/trace.json, naming the
timed phases and the operators under them; with the key unset nothing is
traced. The counterpart of the JAX package's device_trace
(splatslam_tpu/utils/profiling.py:74-82, slam.py:72,183)."""

import contextlib
import json
import os
import warnings

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


# -- the tracer: phases, spans and counters ----------------------------------

def _stub_syncs(timers):
    syncs = []
    timers._sync = lambda: syncs.append(list(timers._open))
    return syncs


def test_a_phase_synchronises_at_both_edges_and_a_span_never():
    t = profiling.PhaseTimers()
    syncs = _stub_syncs(t)
    with t("mapping"):
        assert syncs == [[]]
        with t("map.opt"):
            for name in sorted(profiling.SPANS):
                with t(name):
                    pass
            assert len(syncs) == 2
    # entered before the phase opens and after it closes
    assert syncs == [[], ["mapping"], ["mapping"], []]
    assert all(t.count[n] == 1 for n in profiling.SPANS)
    assert t.count["mapping"] == t.count["map.opt"] == 1
    assert t.total["mapping"] >= t.total["map.opt"] > 0


def test_record_function_only_while_a_profiler_runs(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def record(name):
        entered.append(name)
        yield

    monkeypatch.setattr(torch.profiler, "record_function", record)
    t = profiling.PhaseTimers()
    with t("frontend"), t("fe.round"):
        pass
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with t("frontend"), t("fe.round"):
            pass
    assert entered == ["frontend", "fe.round"]
    with t("mapping"):
        pass
    assert entered == ["frontend", "fe.round"]


def test_span_without_current_timers_is_a_no_op():
    profiling.set_current(None)
    with profiling.span("map.fwd"):
        profiling.tally("n.edges", 3)
    t = profiling.PhaseTimers()
    profiling.set_current(t)
    try:
        with profiling.span("map.fwd"):
            profiling.tally("n.edges", 3)
        profiling.tally("n.edges", 4)
    finally:
        profiling.set_current(None)
    assert t.count == {"map.fwd": 1, "n.edges": 2}
    assert t.total["n.edges"] == 7
    with pytest.raises(ValueError):
        profiling.span("mapping")      # a phase synchronises: not a span


def test_counters_are_reported_apart_from_seconds():
    t = profiling.PhaseTimers()
    t.add("frontend", 1.5)
    t.tally("n.edges", 120)
    t.tally("n.edges", 80)
    phases, counters = t.report().split("\n\n")
    assert "frontend" in phases and "n.edges" not in phases
    assert "total_s" in phases.splitlines()[0]
    head, row = counters.splitlines()
    assert head.split() == ["counter", "total", "calls"]
    assert row.split() == ["n.edges", "200", "2"]
    assert "counter" not in profiling.PhaseTimers().report()


def test_sync_warnings_are_counted_where_they_happen(monkeypatch):
    """The counting itself, on the CPU: torch's per-sync warning stood in
    by warnings.warn. Counted under the innermost open name while on,
    other warnings passed on, nothing counted once off; a CPU run never
    turns it on."""
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    sync = profiling.SYNC_WARNING + " (Triggered internally at x.cpp:1.)"
    t = profiling.PhaseTimers()
    t._watch_syncs(True)
    try:
        with t("frontend"):
            warnings.warn(sync)
            with t("fe.round"):
                warnings.warn(sync)
                warnings.warn(sync)
            with pytest.warns(DeprecationWarning):
                warnings.warn("another", DeprecationWarning)
        warnings.warn(sync)
    finally:
        t._watch_syncs(False)
    assert modes == ["warn", 0]
    assert t.total["n.sync"] == 4 and t.count["n.sync"] == 4
    assert t.total["n.sync.fe.round"] == 2
    assert t.total["n.sync.frontend"] == 1
    assert t.total[f"n.sync.{profiling.OUTSIDE}"] == 1
    with pytest.warns(UserWarning, match=profiling.SYNC_WARNING):
        warnings.warn(sync)
    assert t.total["n.sync"] == 4
    from torch.profiler import ProfilerActivity, profile
    cpu = profiling.PhaseTimers("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with cpu("frontend"):
            pass
    assert cpu.total.get("n.sync", 0) == 0 and modes == ["warn", 0]


def test_span_range_holds_the_profiler_events_launched_in_it():
    """benchmark/trace.py stamps each phase and span with time.time_ns()
    and compares the stamps with the profiler's: on the CPU, the events
    an operator issues inside a span start inside its range, those before
    and after outside it."""
    from benchmark import probes, trace
    t = profiling.PhaseTimers()
    host = trace.HostRanges()
    patches = probes.Patches()
    host.install(patches)
    host.active = True
    x = torch.ones(256)
    prof = trace.start("cpu")
    try:
        x - 1
        with t("map.fwd"):
            for _ in range(3):
                x * 2
        x / 2
    finally:
        trace.stop(prof)
        patches.remove()
    ((name, lo, hi),) = host.ranges
    assert name == "map.fwd"
    starts = {}
    for e in prof.profiler.kineto_results.events():
        starts.setdefault(e.name(), []).append(e.start_ns())
    assert len(starts["aten::mul"]) == 3
    assert all(lo <= s <= hi for s in starts["aten::mul"])
    assert all(s < lo for s in starts["aten::sub"])
    assert all(s > hi for s in starts["aten::div"])


def test_spans_and_counters_of_a_slam_run(tmp_path, monkeypatch):
    """A tiny oracle run with mapping: one `fe.round` a round run, the
    edge counter the edges handed to the rounds, one `map.iter` a mapping
    iteration; no span synchronises, so the phases' meaning stays."""
    from splatslam_tpu_torch.mapping import mapper as mapper_mod
    from splatslam_tpu_torch.ops import ba as ba_ops
    from splatslam_tpu_torch.slam import SLAM
    from splatslam_tpu_torch.tracking.factor_graph import FactorGraph
    from test_torch_slam import _cfg as slam_cfg
    monkeypatch.chdir(REPO)
    rounds, edges, iters, inside = [], [], [], []
    update_rounds = FactorGraph.update_rounds
    make_edges = ba_ops.make_edges
    step_shards = mapper_mod._step_shards

    def counted_rounds(self, opt_types, *a, **kw):
        if len(self.ii):
            rounds.append(len(opt_types))
        inside.append(True)
        try:
            return update_rounds(self, opt_types, *a, **kw)
        finally:
            inside.pop()

    def counted_edges(ii, *a, **kw):
        if inside and len(edges) < len(rounds):
            edges.append(len(ii))
        return make_edges(ii, *a, **kw)

    def counted_iters(*a, **kw):
        iters.append(1)
        return step_shards(*a, **kw)

    monkeypatch.setattr(FactorGraph, "update_rounds", counted_rounds)
    monkeypatch.setattr(ba_ops, "make_edges", counted_edges)
    monkeypatch.setattr(mapper_mod, "_step_shards", counted_iters)
    cfg = slam_cfg(tmp_path / "out")
    cfg["mapping"]["final_refine_iters"] = 8
    slam = SLAM(cfg, device="cpu")
    try:
        res = slam.run()
    finally:
        profiling.set_current(None)
    assert np.isfinite(res["ate_rmse"])
    t = slam.timers
    assert rounds and iters
    assert t.count["fe.round"] == sum(rounds)
    assert t.total["n.edges"] == sum(r * e for r, e in zip(rounds, edges))
    assert t.count["n.edges"] == sum(rounds)
    assert t.count["map.iter"] == t.count["map.fwd"] == len(iters)
    assert t.count["map.adam"] == t.count["map.bwd"] == len(iters)
    assert t.count["fe.setup"] == len(rounds)
    assert t.count["map.bin"] > 0 and t.count["map.pull"] > 0
    assert "fe.update" not in t.count      # oracle targets: no network
    assert t.count["fe.dba"] + t.count.get("fe.dspo", 0) >= sum(rounds)
    assert "n.sync" not in t.total
