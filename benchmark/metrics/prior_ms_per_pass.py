"""Milliseconds of one pass of the monocular prior's network (the
program's `mono.dpt` span: upload, resize, network, clamp, resize back,
host pull) over the passes made (its `n.mono.dpt` counter: cache and disk
hits excluded) in the traced window. None where the program does not
count them."""


def read(rec):
    t = rec["part"]["timers"]["seconds"]
    passes = t.get("n.mono.dpt")
    if not passes:
        return None
    return 1e3 * t.get("mono.dpt", 0.0) / passes
