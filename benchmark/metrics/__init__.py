"""Per-layer metric readers, one module per metric of BENCHMARK.json's
`per_layer`, each with `read(rec)`: the metric from a traced run's record,
or None when the record holds nothing to read.

The record (harness.run): `part` — the window:
`window_s`, `frames`, `timers` (`seconds` and `calls` by phase-timer
name, `mapped`: keyframes the mapper optimised); `trace` (trace.reduce:
`busy_s`, `kernels`, `ops`, `idle_by_host`, `launches` — each B1/B2
launch's device seconds in order); `launches` — each B1/B2 launch's
(name, B, N, T, K, pairs, live pairs or None) in order; `flops` — the
frozen FLOP model's count of the window's work, summed over the kinds of
`flops_by_kind` ({kind: FLOPs}, flop_terms/); `peak_flops` — the card's
dense bf16 peak, or None; `bound_ms` — bounds.launch_bound_ms.
"""
