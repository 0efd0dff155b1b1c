"""The frozen kernel bounds equal the program's on the inputs the kernel
table was measured on (the pair counts of PERF.md's cells section: the
kernel phase, one camera, a final window, the learned window, the
profiler's clouds), with and without live pairs."""

import pytest

from benchmark import bounds

# (B, N, T, K, pairs, live share)
INPUTS = [
    (10, 131072, 800, 256, 520_000_000, 0.21),
    (1, 131072, 800, 256, 51_600_000, 0.21),
    (10, 131072, 800, 256, 416_000_000, 0.10),
    (8, 32768, 300, 128, 58_500_000, 0.12),
    (12, 262144, 800, 256, 412_000_000, 0.38),
    (12, 262144, 800, 256, 605_000_000, 0.13),
]


@pytest.mark.parametrize("B,N,T,K,pairs,share", INPUTS)
@pytest.mark.parametrize("with_live", [False, True])
def test_bounds_equal_the_programs(B, N, T, K, pairs, share, with_live):
    from splatslam_tpu_torch.ops import raster_cuda
    live = int(pairs * share) if with_live else None
    assert bounds.kernel_bounds(B, N, T, K, pairs, live) == \
        raster_cuda.kernel_bounds(B, N, T, K, pairs, live)


def test_unknown_live_pairs_stay_a_bound():
    B, N, T, K, pairs = INPUTS[0][:5]
    for name in ("composite_fwd", "composite_bwd"):
        low = bounds.launch_bound_ms(name, B, N, T, K, pairs, None)
        assert low <= bounds.kernel_bounds(B, N, T, K, pairs, pairs // 5)[
            name][0]
