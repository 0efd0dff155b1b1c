"""Milliseconds of mapping per keyframe the mapper optimised in the
traced window, from the program's phase timers."""


def read(rec):
    t = rec["part"]["timers"]
    if not t["mapped"]:
        return None
    return 1e3 * t["seconds"].get("mapping", 0.0) / t["mapped"]
