"""Kernels the device ran per frame of the traced window, from the trace."""


def read(rec):
    if rec["trace"] is None or not rec["part"]["frames"]:
        return None
    return rec["trace"]["kernels"] / rec["part"]["frames"]
