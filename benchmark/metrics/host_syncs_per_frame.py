"""The host's blocking waits on the device per frame of the traced window:
the program's `n.sync` counter (counted while a profiler runs, the
program's own phase-edge synchronisations left out); the record keeps a
counter's sum under `seconds`. None where the program does not count."""


def read(rec):
    part = rec["part"]
    syncs = part["timers"]["seconds"].get("n.sync")
    if syncs is None or not part["frames"]:
        return None
    return syncs / part["frames"]
