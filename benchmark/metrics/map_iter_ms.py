"""Milliseconds of the mapper's optimisation (the `map.opt` phase: the
window's iterations with their binning, densification, the closing pull
and the prune render) per mapping iteration (calls of the program's
`map.iter` span) in the traced window, from the program's timers."""


def read(rec):
    t = rec["part"]["timers"]
    iters = t["calls"].get("map.iter", 0)
    if not iters:
        return None
    return 1e3 * t["seconds"].get("map.opt", 0.0) / iters
