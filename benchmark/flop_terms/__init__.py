"""The FLOP terms: the program entries that `probes.Counters` wraps in a
traced window, each with the kind its count goes under and the work it
counts. One table a module: every module here (its name not starting
with `_`) holds `TERMS`, a list of `Term`s, and the counters install the
terms of all of them, so a term is added as a new file. The record's
`flops` sums every kind (harness.run).

A term's `make(orig, counters, add)` returns the wrapper of `orig`: it
reads the sizes it needs from the arguments (and from `counters`: `H`,
`W`, `K`, `hw`, `h8w8` of the cell's frames, `active` while the window
runs) and hands `add` the FLOPs (a float, or a 0-d device tensor where a
count lives on the device), which `add` keeps only while the window runs.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Term:
    """`owner` a module or class of the program, whose `attribute` the
    program looks up at call time; `kind` the total its count goes to."""
    owner: object
    attribute: str
    kind: str
    make: Callable


def terms():
    """Every module's TERMS, modules in name order."""
    out = []
    for info in sorted(pkgutil.iter_modules(__path__), key=lambda m: m.name):
        if not info.name.startswith("_"):
            out += importlib.import_module(f"{__name__}.{info.name}").TERMS
    return out
