"""The port's one tracer: phases, spans and counters, and the profiler
trace (counterpart of splatslam_tpu/utils/profiling.py).

A *phase* synchronises a CUDA device at both edges, so its time is its own
device work: PyTorch launches asynchronously and an unsynchronised host
clock would charge queued kernels to whichever later phase happens to wait
first. A *span* (a name in SPANS) never synchronises: its time is the
host's, and it splits a phase into the parts the host passes through. Its
name alone decides which it is. A *counter* (a name that starts with
`n.`) accumulates a count in the same tables. While a torch profiler runs,
every phase and span is also a `record_function` range, so a trace shows
them by name next to the device activity; without one nothing is entered.

`SLAM` makes its timers the process's current timers; `span(name)` and
`tally(name, n)` reach them from free functions, and do nothing when no
timers are current.

Which metric reads each span and counter (benchmark/metrics/):
  map.iter               map_iter_ms (calls)
  n.map.graphed          map_graphed_pct (over map.iter's calls)
  map.*                  map_idle_pct (idle under them)
  fe.round, n.edges      round_us_per_edge
  fe.*, lc.*             frontend_idle_pct (idle under them)
  n.sync                 host_syncs_per_frame
  mono.dpt, n.mono.dpt   prior_ms_per_pass, prior_mfu (a DPT pass each)
  mono.save              none (the prior's .npy write)
  n.dspo.bad_mono,       none (the share of stage 2's depth frames whose
  n.dspo.frames            prior fit is bad)
  n.dspo.iter,           dspo_kernel_pct (stage-2 iterations, and those
  n.dspo.kernel            that ran as the kernel of csrc/dspo.cu)
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch

# the spans, by where they are entered
SPANS = frozenset({
    # mapping/mapper.py: map_step_n, _step_shards, _SplitStep,
    # Mapper._run_iters and Mapper._handle_host_events
    "map.bin", "map.iter", "map.fwd", "map.bwd", "map.adam", "map.densify",
    "map.pull", "map.capture",
    # tracking/factor_graph.py: FactorGraph.update_rounds
    "fe.setup", "fe.round", "fe.update", "fe.dba", "fe.dspo", "fe.cull",
    # tracking/backend.py: Backend.ba
    "lc.edges",
    # models/dpt.py: DPTDepthPredictor.__call__; mono_prior.py
    "mono.dpt", "mono.save",
})
COUNTER_PREFIX = "n."
SYNCS = "n.sync"      # blocking waits on the device, n.sync.<where> by name
SYNC_WARNING = "called a synchronizing CUDA operation"
OUTSIDE = "(between phases)"


class PhaseTimers:
    """Accumulating named wall-clock timers and counters.

    with timers("frontend"): ...      # a phase (or a span, by its name)
    timers.tally("n.edges", 42)       # a counter
    timers.report() -> str tables sorted by total.

    `total[name]` holds seconds, or a counter's sum; `count[name]` the
    calls. On a CUDA device, while a torch profiler runs, the host's
    blocking waits on the device are counted under `n.sync` and
    `n.sync.<innermost open phase or span>` (checked at each phase edge;
    the phases' own synchronisations are not counted).
    """

    def __init__(self, device=None):
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.device = torch.device(device) if device is not None else None
        self._open: list[str] = []
        self._counting = None      # catch_warnings while n.sync counts

    def _sync(self):
        if self.device is None or self.device.type != "cuda":
            return
        self._watch_syncs(torch.autograd._profiler_enabled())
        if self._counting is None:
            torch.cuda.synchronize(self.device)
            return
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(self.device)
        torch.cuda.set_sync_debug_mode("warn")

    def _watch_syncs(self, on):
        """Start or stop counting the device synchronisations, so that it
        runs while a profiler does."""
        if on == (self._counting is not None):
            return
        if on:
            for d in (self.total, self.count):
                d.setdefault(SYNCS, 0)
            self._counting = warnings.catch_warnings()
            self._counting.__enter__()
            shown = warnings.showwarning

            def count(message, category, *a, **kw):
                if str(message).startswith(SYNC_WARNING):
                    where = self._open[-1] if self._open else OUTSIDE
                    self.tally(SYNCS, 1)
                    self.tally(f"{SYNCS}.{where}", 1)
                else:
                    shown(message, category, *a, **kw)

            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.showwarning = count
            torch.cuda.set_sync_debug_mode("warn")
        else:
            torch.cuda.set_sync_debug_mode(0)
            self._counting.__exit__(None, None, None)
            self._counting = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        phase = name not in SPANS
        if phase:
            self._sync()
        t0 = time.perf_counter()
        self._open.append(name)
        try:
            if torch.autograd._profiler_enabled():
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            self._open.pop()
            if phase:
                self._sync()
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float):
        self.total[name] = self.total.get(name, 0.0) + dt
        self.count[name] = self.count.get(name, 0) + 1

    def tally(self, name: str, n):
        """Counter `name` (it starts with `n.`) += n, one call."""
        self.total[name] = self.total.get(name, 0) + n
        self.count[name] = self.count.get(name, 0) + 1

    def report(self) -> str:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        lines = [f"{'phase':<22}{'total_s':>10}{'calls':>8}{'mean_ms':>10}"]
        counters = [f"{'counter':<30}{'total':>12}{'calls':>8}"]
        for name, tot in rows:
            n = self.count[name]
            if name.startswith(COUNTER_PREFIX):
                counters.append(f"{name:<30}{tot:>12g}{n:>8}")
            else:
                lines.append(f"{name:<22}{tot:>10.2f}{n:>8}"
                             f"{1000.0 * tot / max(n, 1):>10.1f}")
        if len(counters) > 1:
            lines += [""] + counters
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: round(v, 4) for k, v in self.total.items()}


_current: PhaseTimers | None = None
_NONE = contextlib.nullcontext()


def set_current(timers: PhaseTimers | None):
    """Make `timers` the ones span() and tally() reach."""
    global _current
    _current = timers


def span(name: str):
    """The current timers' span `name` (a name in SPANS), or nothing."""
    if name not in SPANS:
        raise ValueError(f"{name!r} is not a span: a phase synchronises, "
                         f"enter it through its timers")
    return _NONE if _current is None else _current(name)


def tally(name: str, n):
    """Counter `name` of the current timers += n, if any are current."""
    if _current is not None:
        _current.tally(name, n)


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
