"""Share of the mapper's time (the `mapping` phase) in which the device
sat idle while the host was inside it: the trace's idle gaps charged to
`mapping` and to every `map.*` phase and span under it."""


def read(rec):
    mapping = rec["part"]["timers"]["seconds"].get("mapping", 0.0)
    if rec["trace"] is None or not mapping:
        return None
    idle = sum(s for name, s in rec["trace"]["idle_by_host"].items()
               if name == "mapping" or name.startswith("map."))
    return 100.0 * idle / mapping
