"""The checked stages, one module each, found by the numbers that a cell's
limits (workloads/<cell>.json) name: a stage is checked in a cell when one
of its numbers has a limit there, so a stage is added as a new file.

A stage module (its name, not starting with `_`, is the stage's) holds:

  NUMBERS                   the numbers it reads, each defined in its
                            docstring;
  arm(slot, patches)        wraps the program entry it takes one call of
                            (a `Patches.put` on a module attribute the
                            program looks up at call time) and puts that
                            call's inputs and outputs, cloned, into
                            `slot` (probes.Slot) at its first call;
  reference(ctx, cap)       the stage worked out again by the plain
                            reference, from the capture and `ctx`;
  gaps(cap, ref)            {number: the program's reading};
  control(ctx, cap, ref)    {number: the control's reading}: the
                            reference in the precision below the one the
                            configuration states, in the program's place.
"""

from __future__ import annotations

import importlib
import pkgutil


class Context:
    """What a stage's reference and control work from: the cell's SLAM
    configuration `cfg` (as the run ran it), the run's `frames` (float
    RGB in [0, 1], as the stream serves them) and the `device`. Networks
    are built on first use, once a run: `droid` is the tracker network,
    read from the shipped checkpoint at `checkpoint`."""

    def __init__(self, cfg, frames, device, checkpoint):
        self.cfg, self.frames, self.device = cfg, frames, device
        self.checkpoint = checkpoint
        self._networks = {}

    def network(self, name, build):
        """The network `name`, built by `build()` at its first request."""
        if name not in self._networks:
            self._networks[name] = build()
        return self._networks[name]

    @property
    def droid(self):
        from ..reference.weights import load_network
        return self.network("droid", lambda: load_network(self.checkpoint,
                                                          self.device))


def name(mod):
    """A stage module's name: its file's."""
    return mod.__name__.rpartition(".")[2]


def modules():
    """{stage name: module} of every stage file."""
    return {m.name: importlib.import_module(f"{__name__}.{m.name}")
            for m in pkgutil.iter_modules(__path__)
            if not m.name.startswith("_")}


def for_limits(limits):
    """The stage modules whose numbers `limits` name, in the order of
    their first number there; a limited number that no stage reads is an
    error."""
    by_number = {}
    for mod in modules().values():
        for n in mod.NUMBERS:
            by_number[n] = mod
    unknown = [n for n in limits if n not in by_number]
    if unknown:
        raise KeyError(f"no stage reads {unknown}; stages read "
                       f"{sorted(by_number)}")
    out = []
    for n in limits:
        if by_number[n] not in out:
            out.append(by_number[n])
    return out
