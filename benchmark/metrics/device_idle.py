"""Share of the traced window in which no operation ran on the device (the
union of the trace's kernel, copy and fill intervals is the busy time)."""


def read(rec):
    if rec["trace"] is None:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["part"]["window_s"])
