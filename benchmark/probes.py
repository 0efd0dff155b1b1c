"""Wrappers the benchmark puts around the program's layer entries.

Two kinds, installed when they are first needed (a traced run's trace
window, or the arming of the check) into one `Patches` that the run
removes as a whole once its loop has stopped:

  * `Counters` (traced runs only): the work each layer was handed, counted
    from the arguments at its entry by the FLOP terms (flop_terms/, over
    the frozen coefficients of flops.py), and each compositing-kernel
    launch's sizes for the kernels' bounds (bounds.py). Device-side counts
    stay device tensors until the trace window has closed, so counting
    adds no host synchronisation.
  * `Capture` (every run): the inputs and outputs of one call of each
    checked stage (stages/), cloned, for the comparison with the
    reference (check.py). Armed late in the window; each stage is taken
    once, at its first call after arming.

A wrapper replaces a module attribute that the program looks up at call
time (a module-level function, or a method on its class) and calls the
original, so the program runs unchanged beneath it.
"""

from __future__ import annotations

import torch

from splatslam_tpu_torch.ops import raster_cuda

from . import flop_terms, stages as stage_files


class Patches:
    """Module attributes replaced by wrappers, put back by `remove`."""

    def __init__(self):
        self._saved = []

    def put(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def remove(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


def clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone(v) for v in x)
    return x


class Counters:
    """What the layers were handed while installed: FLOPs by kind, as the
    FLOP terms count them (device tensors summed at `read`), and one
    record per launch of B1/B2: (name, B, N, T, K, pairs, live pairs or
    None)."""

    def __init__(self, H, W, K):
        self.H, self.W, self.K = H, W, K
        self.hw = H * W
        self.h8w8 = (H // 8) * (W // 8)
        self.active = False
        self.flops = []          # (kind, float or 0-d device tensor)
        self.launches = []
        self._live = {}          # B1's live pairs by packets' data pointer
        self._kinds = []

    def install(self, p):
        """Wrap the FLOP terms' entries and the compositing kernels (into
        Patches `p`); they count while `active` is set."""
        for t in flop_terms.terms():
            self._kinds.append(t.kind)
            p.put(t.owner, t.attribute,
                  lambda orig, t=t: t.make(orig, self, self._adder(t.kind)))

        def fwd(orig):
            def f(packets, tile_ids, counts, ntx, want_touched=True):
                out, nt = orig(packets, tile_ids, counts, ntx, want_touched)
                if not self.active:
                    return out, nt
                live = nt.sum() if want_touched else None
                self._live[packets.data_ptr()] = live
                self._launch("composite_fwd", packets, tile_ids, counts,
                             live)
                return out, nt
            return f

        def bwd(orig):
            def f(packets, tile_ids, counts, ntx, gout, fwdout):
                grad = orig(packets, tile_ids, counts, ntx, gout, fwdout)
                if not self.active:
                    return grad
                self._launch("composite_bwd", packets, tile_ids, counts,
                             self._live.pop(packets.data_ptr(), None))
                return grad
            return f

        p.put(raster_cuda, "composite_fwd", fwd)
        p.put(raster_cuda, "composite_bwd", bwd)

    def _adder(self, kind):
        def add(x):
            if self.active:
                self.flops.append((kind, x))
        return add

    def _launch(self, name, packets, tile_ids, counts, live):
        B, N, _ = packets.shape
        _, T, K = tile_ids.shape
        pairs = 256 * torch.clamp(counts, max=K).sum()
        self.launches.append((name, B, N, T, K, pairs, live))

    def read(self):
        """({kind: FLOPs} over every installed term's kind, launches with
        pairs and live pairs as ints)."""
        total = dict.fromkeys(self._kinds, 0.0)
        for kind, x in self.flops:
            total[kind] += float(x)
        launches = [(n, B, N, T, K, int(p), None if lv is None else int(lv))
                    for n, B, N, T, K, p, lv in self.launches]
        return total, launches


class Slot:
    """Where one stage's capture goes (`put`), and whether it came
    (`full`); `video` is the program's DepthVideo."""

    def __init__(self, got, name, video):
        self.got, self.name, self.video = got, name, video

    @property
    def full(self):
        return self.name in self.got

    def put(self, cap):
        self.got[self.name] = cap


class Capture:
    """One call of each checked stage, taken at its first call after
    `arm()`: `stages` are the stage modules a cell's limits name
    (stages.for_limits); each wraps its own program entry. No other
    stage is waited for."""

    def __init__(self, stages, video):
        self.stages = list(stages)
        self.video = video
        self.armed = False
        self.got = {}

    @property
    def complete(self):
        return all(stage_files.name(s) in self.got for s in self.stages)

    def arm(self, p):
        """Wrap the checked stages' entries (into Patches `p`)."""
        self.armed = True
        for s in self.stages:
            s.arm(Slot(self.got, stage_files.name(s), self.video), p)
