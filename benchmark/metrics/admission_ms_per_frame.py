"""Milliseconds of the motion filter (encoders and the admission scan)
per frame of the traced window, from the program's phase timers."""


def read(rec):
    part = rec["part"]
    if not part["frames"]:
        return None
    return 1e3 * part["timers"]["seconds"].get("motion_filter", 0.0) \
        / part["frames"]
