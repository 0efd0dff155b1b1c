"""Share of the update operator's calls in the traced window (the
program's `n.corr.call` counter, one a call of
`tracking/factor_graph.update_operator`) whose local correlation ran as the
hand-written kernel (its `n.corr.kernel` counter, one a launch; the record
keeps a counter's sum under `seconds`). None where the program does not
count the calls or made none."""


def read(rec):
    t = rec["part"]["timers"]["seconds"]
    calls = t.get("n.corr.call")
    if not calls:
        return None
    return 100.0 * t.get("n.corr.kernel", 0) / calls
