"""Milliseconds of the frontend (update rounds, loop closure) and online
BA per keyframe the frontend took in the traced window, from the program's
phase timers; a keyframe is one frontend update (one `fe.edges` phase)."""


def read(rec):
    t = rec["part"]["timers"]
    kfs = t["calls"].get("fe.edges", 0)
    if not kfs:
        return None
    return 1e3 * (t["seconds"].get("frontend", 0.0)
                  + t["seconds"].get("online_ba", 0.0)) / kfs
