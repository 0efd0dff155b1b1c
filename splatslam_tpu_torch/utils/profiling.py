"""Per-phase wall timers and the profiler trace (counterpart of
splatslam_tpu/utils/profiling.py).

On a CUDA device every phase edge synchronises the device, so each
phase's time is its own device work: PyTorch launches asynchronously and
an unsynchronised host clock would charge queued kernels to whichever
later phase happens to wait first. Each phase is also a
`record_function` range, so a trace shows the phases by name.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class PhaseTimers:
    """Accumulating named wall-clock timers.

    with timers("frontend"): ...      # accumulate
    timers.report() -> str table sorted by total time.
    """

    def __init__(self, device=None):
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.device = torch.device(device) if device is not None else None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._sync()
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float):
        self.total[name] = self.total.get(name, 0.0) + dt
        self.count[name] = self.count.get(name, 0) + 1

    def report(self) -> str:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        lines = [f"{'phase':<22}{'total_s':>10}{'calls':>8}{'mean_ms':>10}"]
        for name, tot in rows:
            n = self.count[name]
            lines.append(
                f"{name:<22}{tot:>10.2f}{n:>8}{1000.0 * tot / max(n, 1):>10.1f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: round(v, 4) for k, v in self.total.items()}


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """torch.profiler over a region when trace_dir is set: CPU activity,
    and CUDA activity when `device` is a CUDA device. On exit the whole
    trace, unsampled, is written to `trace_dir/trace.json` (Chrome trace
    format: chrome://tracing or ui.perfetto.dev). Nothing when trace_dir is
    unset."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
