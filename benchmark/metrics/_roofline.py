"""A compositing kernel's share of its roofline over the traced window: the
launches' least times (bounds.launch_bound_ms of each launch's sizes)
over their device times in the trace, matched launch by launch."""


def share(rec, name):
    sizes = [x for x in rec["launches"] if x[0] == name]
    times = rec["trace"]["launches"][name] if rec["trace"] else []
    if not sizes or len(sizes) != len(times):
        return None
    bound_s = sum(rec["bound_ms"](*x) for x in sizes) * 1e-3
    return 100.0 * bound_s / sum(times)
