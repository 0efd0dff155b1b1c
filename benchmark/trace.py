"""The traced run's device trace: torch.profiler over a part of the window,
reduced to what the per-layer metrics and the breakdown read.

The profiler records device activity only (kernels, copies, fills): with
the host's operators recorded as well, a learned-tracking frame took
three times as long under the profiler (a frame launches ~15 000
kernels), and the per-layer times and the idle share would describe the
profiler. What the host was doing comes instead from the program's phase
timers: `HostRanges` records each phase's wall interval on the clock the
profiler stamps its events with (the system clock, in ns).

The reduction walks the device events once. Busy time is the union of
their intervals; an idle gap between two of them is charged to the
innermost phase that was open when the gap began.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from splatslam_tpu_torch.utils.profiling import PhaseTimers

COPY_PREFIXES = ("Memcpy", "Memset")     # device copies and fills
TOP = 10


def start(device):
    """A running profiler over a CUDA device (over the host on the CPU,
    where there is no device activity to record)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def stop(prof):
    prof.__exit__(None, None, None)


class HostRanges:
    """(name, start ns, end ns) of every phase-timer phase while `active`
    (the wrapper goes into a probes.Patches)."""

    def __init__(self):
        self.active = False
        self.ranges = []

    def install(self, p):
        def wrap(orig):
            @contextlib.contextmanager
            def timed(timers, name):
                t0 = time.time_ns()
                try:
                    with orig(timers, name):
                        yield
                finally:
                    if self.active:
                        self.ranges.append((name, t0, time.time_ns()))
            return timed
        p.put(PhaseTimers, "__call__", wrap)


def _union(starts, ends):
    """Merged intervals of [starts, ends) sorted by start."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def reduce(prof, host_ranges=(), tracked=("composite_fwd", "composite_bwd")):
    """{busy_s, kernels (count), ops {name: seconds}, idle_by_host
    {phase: seconds}, launches {tracked name: [seconds of each launch in
    start order]}}; a tracked name matches a kernel whose demangled name
    holds `<name>_kernel`. None when the device ran nothing."""
    dev_name, dev_s, dev_e, kernels = [], [], [], 0
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu or e.is_user_annotation():
            continue
        name = e.name()
        dev_name.append(name)
        dev_s.append(e.start_ns())
        dev_e.append(e.start_ns() + e.duration_ns())
        kernels += not name.startswith(COPY_PREFIXES)
    if not dev_s:
        return None
    ds, de = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    us, ue = _union(ds, de)
    busy_s = float((ue - us).sum()) * 1e-9

    ops = {}
    launches = {t: [] for t in tracked}
    for i in np.argsort(ds, kind="stable"):
        n, dt = dev_name[i], float(de[i] - ds[i]) * 1e-9
        ops[n] = ops.get(n, 0.0) + dt
        for t in tracked:
            if t + "_kernel" in n:
                launches[t].append(dt)

    # idle gaps between merged busy intervals, each charged to the
    # innermost phase open at its start (outer phases first, inner ones
    # overwrite)
    gs, ge = ue[:-1], us[1:]
    label = np.full(len(gs), -1)
    names = [r[0] for r in host_ranges]
    if host_ranges:
        a_s = np.asarray([r[1] for r in host_ranges], np.int64)
        a_e = np.asarray([r[2] for r in host_ranges], np.int64)
        for j in np.argsort(-(a_e - a_s), kind="stable"):
            lo, hi = np.searchsorted(gs, [a_s[j], a_e[j]])
            label[lo:hi] = j
    sums = np.bincount(label + 1, weights=(ge - gs) * 1e-9,
                       minlength=len(names) + 1)
    idle = {}
    for j in np.flatnonzero(sums):
        name = names[j - 1] if j > 0 else "(between phases)"
        idle[name] = idle.get(name, 0.0) + float(sums[j])
    return dict(busy_s=busy_s, kernels=kernels, ops=ops, idle_by_host=idle,
                launches=launches)


def top(d, n=TOP):
    """The n largest entries of {name: seconds} as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
