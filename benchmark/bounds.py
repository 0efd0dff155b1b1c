"""The card's peaks and the least time of the two compositing kernels.

`kernel_bounds` is a frozen copy of the port's
`ops/raster_cuda.kernel_bounds` (taken when the benchmark was written; a
test holds the two equal), so the kernels' roofline shares are reckoned
by arithmetic that a later change to the program cannot move.
"""

# dense bf16 tensor-core peak in FLOP/s by torch.cuda.get_device_name():
# NVIDIA's H100 SXM5 datasheet, 1979 TFLOP/s with sparsity, halved
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}

# A (pixel, contributor) pair that carries a weight costs, in FP32
# operations counted from the arithmetic the plain compositor defines (exp
# as one): B1 evaluates the Gaussian (11), gates and clamps alpha (5),
# updates transmittance and the weight (4) and accumulates four channels
# (8); B2 repeats the evaluation and gating (20), forms s and the suffix
# (9), dL/dalpha (6), the chain through the clamp (3), the ten field
# products (20) and its share of the sum over the tile's pixels (2). A pair
# without a weight is an exact zero of both functions, known after the
# evaluation (11) and one comparison (1).
FWD_OPS_PER_PAIR = 28
BWD_OPS_PER_PAIR = 60
DEAD_OPS_PER_PAIR = 12
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_OPS_PER_S = 67e12          # H100 SXM FP32 outside the tensor cores


def kernel_bounds(B, N, T, K, pairs, live_pairs=None):
    """Least milliseconds an H100 could take for B1 and B2 on one input:
    {"composite_fwd": (ms, "bytes" | "operations"), "composite_bwd": ...}.

    The larger of the bytes each function must move (every input read
    once, every output written once) over the card's memory rate and its
    FP32 operations over the card's peak rate outside the tensor cores.
    `pairs` is the input's (pixel, contributor) pair count,
    256 · Σ min(count, K), and `live_pairs` how many of them carry a
    weight > 0 (the sum of B1's n_touched): those cost the full 28 (B1) or
    60 (B2) operations, the others 12. Without `live_pairs` every pair is
    charged in full."""
    live = pairs if live_pairs is None else live_pairs
    dead = pairs - live
    n_in = 4 * (B * N * 10 + B * T * K + B * T)
    n_out = 4 * B * T * 5 * 256
    fwd_bytes = n_in + n_out + 4 * B * N
    bwd_bytes = n_in + 2 * n_out + 4 * B * N * 10

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    dead_ops = dead * DEAD_OPS_PER_PAIR
    return {
        "composite_fwd": bound(fwd_bytes, live * FWD_OPS_PER_PAIR + dead_ops),
        "composite_bwd": bound(bwd_bytes, live * BWD_OPS_PER_PAIR + dead_ops)}


def launch_bound_ms(name, B, N, T, K, pairs, live):
    """The least time of one launch. Where B1 did not count its live pairs
    (n_touched off) the pairs are charged at the dead rate, every pair's
    least work, so the bound stays a bound."""
    return kernel_bounds(B, N, T, K, pairs,
                         0 if live is None else live)[name][0]
