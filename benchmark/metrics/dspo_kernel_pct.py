"""Share of the stage-2 DSPO iterations in the traced window (the
program's `n.dspo.iter` counter, one a call of
`ops/ba._scale_shift_iteration`) that ran as the hand-written kernel (its
`n.dspo.kernel` counter, one a launch; the record keeps a counter's sum
under `seconds`). None where the program does not count the iterations or
ran none."""


def read(rec):
    t = rec["part"]["timers"]["seconds"]
    iters = t.get("n.dspo.iter")
    if not iters:
        return None
    return 100.0 * t.get("n.dspo.kernel", 0) / iters
