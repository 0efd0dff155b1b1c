"""Share of the frontend's and online BA's time (the `frontend` and
`online_ba` phases) in which the device sat idle while the host was inside
them: the trace's idle gaps charged to those phases and to every `fe.*`
and `lc.*` phase and span under them."""

NAMES = ("frontend", "online_ba")


def read(rec):
    t = rec["part"]["timers"]["seconds"]
    spent = sum(t.get(name, 0.0) for name in NAMES)
    if rec["trace"] is None or not spent:
        return None
    idle = sum(s for name, s in rec["trace"]["idle_by_host"].items()
               if name in NAMES or name.startswith(("fe.", "lc.")))
    return 100.0 * idle / spent
