"""The compositor's hard inputs (tests/composite_cases.py) through the plain versions of B1/B2 against the JAX package's Pallas kernels
in interpret mode, as tests/test_rasterizer.py runs them on the CPU.

Tolerances are tests/test_rasterizer.py's and test_torch_rasterizer.py's:
colour/depth atol 1e-5, n_touched exact, gradients rtol/atol 2e-4. Alpha is
held to 1e-5 too, except in the saturated case: there both packages stop a
tile once every pixel has T < 1e-4, which bounds alpha's difference by 1e-4.

In the saturated case the three conic fields' absolute tolerance is 1e-3 of
the field's largest magnitude, every other field keeps 2e-4: at and behind
the opaque entries the suffix term (G - s_after)/(1 - alpha) is the rounding
noise of s_tot - pre, amplified by 1/(1 - alpha) ~ 10 and, for the conic
fields, by dx^2 ~ 1e3 and summed over every pixel of the image; the two
packages sum in different orders.

The "elongated" case (axes 30 and 3 px) is what the CUDA kernels' per-tile
cull acts on and is held to the same tolerances as the rest. Its sharper
twin "needle" (0.6 px) is not compared with the JAX package: its power is a
difference of terms ~1e3 times larger than itself, so the two CPU backends'
roundings (fused or not) already move colours by 5e-5. It is there for the
GPU, where kernel and plain version round every operation alike.

The Pallas kernels walk K in chunks of min(32, K) and want K a multiple of
the chunk, so K = 80 is handed to them padded to 96 with -1 entries, which
add nothing by definition. tests/test_torch_cuda.py runs the same cases
through the CUDA kernels against the plain versions on a GPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.ops import rasterizer as jrz, raster_pallas as jrp
from splatslam_tpu_torch.ops import rasterizer as trz, raster_cuda
from composite_cases import CASES, make_case
from test_torch_threads import few_torch_threads  # noqa: F401

T = torch.as_tensor

# every case with n_touched; two of them without it as well
PARAMS = [(c, True) for c in CASES if c != "needle"] + [
    ("overflow", False), ("saturated", False)]


def _pallas(case, want_touched):
    pk, ids, counts, gout = (case[k] for k in ("packets", "tile_ids",
                                               "counts", "gout"))
    B, N, _ = pk.shape
    _, Tn, K = ids.shape
    if K > jrp.CH and K % jrp.CH:
        pad = -K % jrp.CH
        ids = np.concatenate([ids, np.full((B, Tn, pad), -1, np.int32)], 2)
    tl_T, ids_smem, counts_flat = jrz._pallas_prep(
        jnp.asarray(ids), jnp.asarray(np.minimum(counts, K)),
        jnp.asarray(pk))
    out, nt = jrp.composite_fwd_pallas(
        counts_flat, tl_T, ids_smem, B, Tn, case["ntx"], N, interpret=True,
        want_touched=want_touched)
    g = gout.reshape(B * Tn, 5, 256)
    gpack = jnp.concatenate([jnp.asarray(g), jnp.zeros((B * Tn, 3, 256))], 1)
    acc = jrp.composite_bwd_pallas(counts_flat, tl_T, ids_smem, gpack, out,
                                   B, Tn, case["ntx"], N, interpret=True)
    grad = np.asarray(acc.transpose(0, 2, 1, 3).reshape(B, 16, N)[:, :10]
                      ).transpose(0, 2, 1)
    nt = np.asarray(nt[:, :, 0, :]).reshape(B, N) if want_touched else None
    return np.asarray(out)[:, :5].reshape(B, Tn, 5, 256), nt, grad


@pytest.mark.parametrize("name,want_touched", PARAMS)
def test_plain_composite_matches_pallas_on_hard_cases(name, want_touched):
    case = make_case(name)
    out_j, nt_j, grad_j = _pallas(case, want_touched)
    pk, ids, counts = T(case["packets"]), T(case["tile_ids"]), \
        T(case["counts"])
    out_t, nt_t = trz.composite_fwd_torch(pk, ids, counts, case["ntx"],
                                          want_touched)
    np.testing.assert_allclose(out_t.numpy()[:, :, :4], out_j[:, :, :4],
                               atol=1e-5)
    np.testing.assert_allclose(out_t.numpy()[:, :, 4], out_j[:, :, 4],
                               atol=1e-4 if name == "saturated" else 1e-5)
    if want_touched:
        np.testing.assert_array_equal(nt_t.numpy(), nt_j)
        assert nt_t.sum() > 0
    else:
        assert not nt_t.any()
    grad_t = trz.composite_bwd_torch(pk, ids, counts, case["ntx"],
                                     T(case["gout"]), out_t)
    assert np.abs(grad_j).max() > 0
    for f in range(10):
        atol = 2e-4
        if name == "saturated" and f in (2, 3, 4):      # the conic fields
            atol = 1e-3 * max(1.0, np.abs(grad_j[..., f]).max())
        np.testing.assert_allclose(grad_t.numpy()[..., f], grad_j[..., f],
                                   rtol=2e-4, atol=atol)


@pytest.mark.parametrize("name", CASES)
def test_cases_exercise_what_they_name(name):
    """Each generator really produces the condition it is named for."""
    c = make_case(name)
    ids, counts = c["tile_ids"], c["counts"]
    K = ids.shape[2]
    inside = np.arange(K) < np.minimum(counts, K)[..., None]
    if name == "overflow":
        assert (counts > K).all()
    elif name == "empty_tiles":
        assert (counts == 0).sum() >= counts.size // 2 and (counts > 0).any()
    elif name == "padding_inside":
        assert ((ids < 0) & inside).any()
    elif name in ("k80", "k24"):
        assert K == int(name[1:]) and K % 32
    elif name == "collisions":
        assert (ids[:, :, 0] == ids[:, :, 1]).all()
        assert (ids[:, :, 5] == 3).all()
    elif name == "saturated":
        out, _ = trz.composite_fwd_torch(T(c["packets"]), T(ids), T(counts),
                                         c["ntx"])
        assert (1.0 - out[:, :, 4]).max() < 1e-4 and K > 64
    elif name in ("elongated", "needle"):
        # some listed Gaussians touch no pixel of their tile, others do
        _, nt = trz.composite_fwd_torch(T(c["packets"]), T(ids), T(counts),
                                        c["ntx"])
        listed = np.zeros(nt.shape, bool)
        for b in range(ids.shape[0]):
            listed[b, ids[b][inside[b] & (ids[b] >= 0)]] = True
        assert (listed & (nt.numpy() == 0)).any() and (nt.numpy() > 0).any()


def test_kernel_bounds_at_the_kernel_phase_input():
    """The bound reckoning chip_smoke.py prints: at B=10, T=800, K=256,
    N=131072 and 520,021,504 pixel-contributor pairs both kernels are bound
    by their FP32 operations, 0.217 ms and 0.466 ms on an H100 with every
    pair charged in full; less when only a share of the pairs carries a
    weight and the rest cost their evaluation and one comparison."""
    b = raster_cuda.kernel_bounds(10, 131072, 800, 256, 520_021_504)
    assert b["composite_fwd"][1] == b["composite_bwd"][1] == "operations"
    assert round(b["composite_fwd"][0], 3) == 0.217
    assert round(b["composite_bwd"][0], 3) == 0.466
    live = raster_cuda.kernel_bounds(10, 131072, 800, 256, 520_021_504,
                                     live_pairs=520_021_504 // 4)
    ops = 520_021_504 // 4 * (28 + 3 * 12)
    assert live["composite_fwd"] == (ops / 67e12 * 1e3, "operations")
    assert abs(live["composite_fwd"][0] - 0.124) < 1e-3
    assert abs(live["composite_bwd"][0] - 0.186) < 1e-3
    # few pairs: the bytes bound instead
    few = raster_cuda.kernel_bounds(10, 131072, 800, 256, 1_000_000)
    assert few["composite_fwd"][1] == few["composite_bwd"][1] == "bytes"
    assert few["composite_bwd"][0] > few["composite_fwd"][0] > 0
    # the pipe model: 17 issues per contributor and warp for B2 at 8 pixels
    # per thread (8000 tiles), 5 for B1 at 4
    p1 = raster_cuda.lsu_pipe_ms("composite_bwd", 520_021_504, 1.98e9, 8000)
    assert abs(p1 - 0.1321) < 1e-3
    p2 = raster_cuda.lsu_pipe_ms("composite_fwd", 520_021_504, 1.98e9, 8000)
    assert abs(p2 - p1 * (5 / 4) / (17 / 8)) < 1e-6


def test_pixels_per_thread_follows_the_grid():
    """One camera (800 tiles) splits a tile over more warps than a full
    window; every value is one the kernel is built for."""
    ppt = raster_cuda.pixels_per_thread
    for name, built in raster_cuda.PIXELS_PER_THREAD.items():
        vals = [ppt(name, n) for n in (1, 800, 1600, 4000, 7200, 8000, 10**6)]
        assert set(vals) == set(built)
        assert vals == sorted(vals)
    assert ppt("composite_fwd", 800) == 2 and ppt("composite_fwd", 8000) == 4
    assert ppt("composite_bwd", 800) == 4 and ppt("composite_bwd", 8000) == 8
