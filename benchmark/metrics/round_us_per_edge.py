"""Microseconds of a frontend update round (the program's `fe.round`
span: update operator, DBA or DSPO stage 2) per edge it covered, over the
traced window. The edges are the program's `n.edges` counter (tallied once
a round: the active and inactive edges handed to that round); the record
keeps a counter's sum under `seconds`."""


def read(rec):
    t = rec["part"]["timers"]["seconds"]
    edges = t.get("n.edges", 0)
    if not edges:
        return None
    return 1e6 * t.get("fe.round", 0.0) / edges
