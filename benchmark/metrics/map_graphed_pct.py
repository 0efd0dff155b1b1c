"""Share of the mapping iterations (calls of the program's `map.iter`
span) in the traced window that were replayed from CUDA graphs (the
program's `n.map.graphed` counter; the record keeps a counter's sum under
`seconds`). None where the program does not count them."""


def read(rec):
    t = rec["part"]["timers"]
    graphed = t["seconds"].get("n.map.graphed")
    iters = t["calls"].get("map.iter", 0)
    if graphed is None or not iters:
        return None
    return 100.0 * graphed / iters
