"""The monocular prior network's share of the card's float32 peak: the
"prior" FLOPs of the traced window (flop_terms/prior.py) over the seconds
of the program's `mono.dpt` span, over the dense float32 peak of one H100
SXM outside the tensor cores (132 SMs × 128 lanes × 2 FLOPs × 1.98 GHz):
the configuration runs the network in float32 with TF32 off. None where
the program has no such span, the window made no pass, or the run was
not on a card the benchmark knows (`peak_flops` None)."""

PEAK_FP32_FLOPS = 132 * 128 * 2 * 1.98e9


def read(rec):
    flops = rec.get("flops_by_kind", {}).get("prior")
    seconds = rec["part"]["timers"]["seconds"].get("mono.dpt")
    if not flops or not seconds or not rec.get("peak_flops"):
        return None
    return 100.0 * flops / seconds / PEAK_FP32_FLOPS
