"""One run of one cell: set-up, the measured window over
`SLAM.run(on_frame=...)`, the check, and the result.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json names its configuration (a file under configs/, the SLAM
configuration as it is run) and its traffic mix (traffic/<name>.json, the
generator's parameters); workloads/<cell>.json holds what the cell
itself needs (the frames it renders, the limits of the numbers its check
reads). A checked stage is stages/<stage>.py, found by the numbers it
reads; a FLOP term is a table under flop_terms/; a per-layer metric is
read by metrics/<name>.py.

The window opens at the on_frame that ends the lead-in (the frontend
initialised, the mapper initialised and two more keyframes mapped) and
closes at the first on_frame at least `seconds` later; a traced run
traces all of it. The check's capture is armed after half the window (in
a traced run, at its close); a stage that has not run by the close is
taken from the loop's next calls, after the window. The loop is ended
from the hook, so the program's terminate() (final BA, refine,
evaluations) never runs.

Each run writes its outputs (the program's saved mono priors among them)
into a directory of its own under $TMPDIR/benchmark, removed when the run
ends: the program reads a saved prior back where it finds one, and a run
that found another run's would time a file read in place of the prior
and track on another scene's depth.
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, probes, scene, stages, trace
from .bounds import PEAK_BF16_FLOPS, launch_bound_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = "pretrained/droid_dba.msgpack"
LEAD_IN_MAPPED = 2      # keyframes mapped after the mapper's initialisation
ARM_SHARE = 0.5         # the share of the window after which the check arms


class _Stop(Exception):
    """Raised from the hook to end the program's loop."""


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """{bench, cell, config, traffic, workload} of the cell `name`."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, bench["paths"][0])
    return dict(
        bench=bench, cell=cell,
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(here, "traffic",
                                        cell["traffic"] + ".json")),
        workload=_load_json(os.path.join(here, "workloads", name + ".json")))


def slam_config(spec, out_dir):
    """The cell's SLAM configuration with its outputs under out_dir."""
    cfg = copy.deepcopy(spec["config"]["slam"])
    cfg["data"]["output"] = out_dir
    cfg["tracking"]["pretrained"] = os.path.join(ROOT, CHECKPOINT)
    cfg["verbose"] = False
    cfg["eval_plots"] = False
    return cfg


def power_limit(device):
    """The power limit in W of a CUDA device, or None where nvidia-smi
    cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip().splitlines()
        return float(out[torch.device(device).index or 0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def read_metric(name, rec):
    """metrics/<name>.py's reading of a run record, or None."""
    mod = importlib.import_module(f"{__package__}.metrics.{name}")
    return mod.read(rec)


class Window:
    """The on_frame hook: lead-in, the measured window, the capture tail.
    Holds the window's frame steps and timer deltas and, in a traced run,
    the trace and the counters of the window."""

    def __init__(self, slam, seconds, traced, capture, device, n_frames):
        self.slam, self.seconds, self.traced = slam, seconds, traced
        self.capture, self.device = capture, device
        self.n_frames = n_frames
        self.phase = "lead"
        self.patches = probes.Patches()
        cfg = slam.cfg
        self.counters = probes.Counters(cfg["cam"]["H_out"],
                                        cfg["cam"]["W_out"],
                                        cfg["mapping"]["raster_K"])
        self.host = trace.HostRanges()
        self.steps = []
        self.t_start = self.t_end = self.t_prev = None
        self.prof = None

    def _snap(self):
        t = self.slam.timers
        m = self.slam.mapper
        return dict(total=dict(t.total), count=dict(t.count),
                    mapped=m._mapped_count if m is not None else 0,
                    keyframes=int(self.slam.video.counter))

    @staticmethod
    def _delta(a, b):
        keys = set(a["total"]) | set(b["total"])
        return dict(
            seconds={k: b["total"].get(k, 0.0) - a["total"].get(k, 0.0)
                     for k in keys},
            calls={k: b["count"].get(k, 0) - a["count"].get(k, 0)
                   for k in keys},
            mapped=b["mapped"] - a["mapped"],
            keyframes=b["keyframes"] - a["keyframes"])

    def _lead_in_done(self):
        s = self.slam
        return (s.frontend.is_initialized and s.mapper is not None
                and s.mapper.initialized
                and s.mapper._mapped_count >= LEAD_IN_MAPPED)

    def __call__(self, i, timestamp, kf_idx):
        if self.phase == "lead":
            if self._lead_in_done():
                trace.sync(self.device)
                self.t_start = self.t_prev = time.perf_counter()
                self.t_start_wall = time.time()
                self.frames = 0
                self.snap0 = self._snap()
                self.phase = "window"
                s = self.slam
                print(f"lead-in: {i + 1} frames, {s.video.counter} "
                      f"keyframes, {s.mapper._mapped_count} mapped",
                      file=sys.stderr)
                if self.traced:
                    self.counters.install(self.patches)
                    self.host.install(self.patches)
                    self.counters.active = self.host.active = True
                    self.prof = trace.start(self.device)
        elif self.phase == "window":
            now = time.perf_counter()
            self.steps.append(now - self.t_prev)
            self.t_prev = now
            self.frames += 1
            el = now - self.t_start
            # a traced run arms the capture after the window: its clones
            # are not traced
            if (not self.traced and not self.capture.armed
                    and el >= ARM_SHARE * self.seconds):
                self.capture.arm(self.patches)
            if el >= self.seconds:
                trace.sync(self.device)
                self.t_end = time.perf_counter()
                self.timers = self._delta(self.snap0, self._snap())
                self.phase = "tail"
                if self.prof is not None:
                    self.counters.active = self.host.active = False
                    trace.stop(self.prof)
                if not self.capture.armed:
                    self.capture.arm(self.patches)
        if self.phase == "tail" and self.capture.complete:
            raise _Stop
        if i >= self.n_frames - 1:
            if self.phase != "tail":
                s = self.slam
                raise RuntimeError(
                    f"the stream's {self.n_frames} frames ran out in the "
                    f"{self.phase} phase ({s.video.counter} keyframes, "
                    f"frontend initialised: {s.frontend.is_initialized}, "
                    f"mapped: {s.mapper._mapped_count}): the cell's "
                    f"n_frames is too small")
            raise _Stop         # a stage that never came reads as missing

    def run(self):
        try:
            self.slam.run(on_frame=self)
        except _Stop:
            pass
        finally:
            self.patches.remove()


def run(cell_name, seed, seconds, traced, device, *, root=ROOT,
        t_process=None, control=False, overrides=None, log=sys.stderr):
    """One run of a cell on `device`. Returns the result object (the
    line's keys), with `checks` last. `overrides(cfg, spec)` may edit the
    configuration (tests shrink it)."""
    t_process = time.time() if t_process is None else t_process
    spec = load_cell(cell_name, root)
    base = os.path.join(os.environ.get("TMPDIR", "/tmp"), "benchmark")
    os.makedirs(base, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix=cell_name + ".", dir=base)
    try:
        return _run(spec, cell_name, seed, seconds, traced, device, root,
                    t_process, control, overrides, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _run(spec, cell_name, seed, seconds, traced, device, root, t_process,
         control, overrides, out_dir):
    wl, tr = spec["workload"], spec["traffic"]
    cfg = slam_config(spec, out_dir)
    if overrides is not None:
        overrides(cfg, spec)
    checked = stages.for_limits(wl["limits"])
    n_frames = int(wl["n_frames"])
    images, depths, c2w = scene.render_frames(
        cfg, seed, n_frames, tr["motion_scale"], tr.get("loop_period", 0))
    stream = scene.Stream(cfg, images, depths, c2w)

    from splatslam_tpu_torch.slam import SLAM
    cuda = torch.device(device).type == "cuda"
    slam = SLAM(cfg, device=device, stream=stream)
    capture = probes.Capture(checked, slam.video)
    win = Window(slam, seconds, traced, capture, device, n_frames)
    win.run()

    setup_s = win.t_start_wall - t_process
    window_s = win.t_end - win.t_start
    frames = win.frames
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    result = dict(correct=None, attempted=frames, failed=0, metrics={})
    red = None
    if not traced:
        values = {"fps": frames / window_s,
                  "frame_ms_p90": 1e3 * float(np.percentile(win.steps, 90)),
                  "setup_s": setup_s}
        for m in spec["bench"]["end_to_end"]:
            if cell_name in m.get("workloads", [cell_name]):
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        red = trace.reduce(win.prof, win.host.ranges)
        flops, launches = win.counters.read()
        name = torch.cuda.get_device_name(device) if cuda else "cpu"
        rec = dict(part=dict(window_s=window_s, frames=frames,
                             timers=win.timers), trace=red,
                   flops=sum(flops.values()), flops_by_kind=flops,
                   launches=launches, peak_flops=PEAK_BF16_FLOPS.get(name),
                   bound_ms=launch_bound_ms)
        for m in spec["bench"]["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            v = read_metric(m["name"], rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
    # the program's state goes before the reference runs on the device
    del slam, win.slam, capture.video
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx = stages.Context(cfg, images, device, os.path.join(root, CHECKPOINT))
    values, refs = check.readings(capture.got, ctx, checked)
    correct, table = check.judge(values, wl["limits"])
    result["correct"] = correct
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=int(peak))
    if cuda:
        dev["power_limit_w"] = power_limit(device)
    if red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": trace.top(red["ops"]),
                               "idle_gaps": trace.top(red["idle_by_host"])}
    result["device"] = dev
    t = win.timers
    # the work the window held: how many keyframes the frontend took and
    # the mapper optimised, and how many loop closures ran
    result["work"] = dict(frames=frames, keyframes=t["keyframes"],
                          frontend_kfs=t["calls"].get("fe.edges", 0),
                          mapped=t["mapped"],
                          loop_closures=t["calls"].get("fe.loop_ba", 0))
    if control:
        ctl = check.control_readings(capture.got, refs, ctx, checked)
        result["control_correct"], result["control"] = check.judge(
            ctl, wl["limits"])
    result["checks"] = table
    return result
