"""The whole SLAM step's share of the card's dense bf16 peak: the frozen
FLOP model's count of the traced window's work (flops.py, over the sizes
read at the wrapped layer entries) over the part's seconds."""


def read(rec):
    if not rec["peak_flops"] or not rec["flops"]:
        return None
    return 100.0 * rec["flops"] / rec["part"]["window_s"] / rec["peak_flops"]
