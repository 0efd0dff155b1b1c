"""The local correlation kernel (csrc/corr.cu) seen from the CPU: the
dispatch of `tracking/factor_graph.update_operator` to the plain
`ops/corr.alt_corr` for CPU tensors, with a gradient or without (in chunks
of `corr_chunk` edges, as before the kernel), the wrapper's refusals (CPU
tensors, and calls that need a gradient), the counters `n.corr.call` / `n.corr.kernel` and the metric
`corr_kernel_pct` that reads them, and the kernel's bound. The kernel
against the plain version on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from benchmark.metrics import corr_kernel_pct
from corr_cases import make_case
from splatslam_tpu_torch.models.droid_net import DroidNet
from splatslam_tpu_torch.ops import corr as corr_ops, corr_cuda
from splatslam_tpu_torch.tracking import factor_graph as fg
from splatslam_tpu_torch.utils import profiling
from test_torch_threads import few_torch_threads  # noqa: F401

B, H, W = 5, 8, 12


@pytest.fixture(scope="module")
def model():
    return DroidNet(device="cpu", generator=torch.Generator().manual_seed(0))


def _inputs(seed=0, n_edges=9):
    """update_operator's arguments on a 5-frame graph at 8 × 12."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((B, 7), np.float32)
    poses[:, 0] = 0.05 * np.arange(B)        # (t, q): translations along x
    poses[:, 6] = 1.0
    ii = rng.randint(0, B, n_edges)
    jj = (ii + rng.randint(1, B, n_edges)) % B
    f = lambda *s: torch.as_tensor(rng.randn(*s).astype(np.float32))
    return dict(
        poses=torch.as_tensor(poses),
        disps=torch.as_tensor(0.4 + 0.2 * rng.rand(B, H, W).astype(
            np.float32)),
        intrinsics=torch.tensor([10.0, 10.0, 5.5, 3.5]),
        fmaps=f(B, 128, H, W).to(torch.bfloat16), inps=f(B, 128, H, W),
        net=f(n_edges, 128, H, W),
        target=f(n_edges, H, W, 2) + torch.as_tensor(
            np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1),
            dtype=torch.float32),
        ii=torch.as_tensor(ii, dtype=torch.long),
        jj=torch.as_tensor(jj, dtype=torch.long))


def _operator(model, a, pyramid=None):
    return fg.update_operator(model, a["poses"], a["disps"], a["intrinsics"],
                              a["fmaps"], a["inps"], a["net"], a["target"],
                              a["ii"], a["jj"], pyramid)


def _spy(monkeypatch):
    """Record the plain alt_corr's calls; the kernel's wrapper must not be
    reached."""
    calls = []
    plain = corr_ops.alt_corr

    def spy(pyr, ii, jj, coords, radius=3):
        out = plain(pyr, ii, jj, coords, radius)
        calls.append((ii.clone(), jj.clone(), coords.clone(), out))
        return out

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(corr_ops, "alt_corr", spy)
    monkeypatch.setattr(corr_cuda, "alt_corr", refuse)
    return calls


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_update_operator_on_the_cpu_takes_the_plain_chunks(model, grad,
                                                           monkeypatch):
    """CPU tensors take ops/corr.alt_corr in chunks of corr_chunk edges,
    their concatenation bit for bit what reaches the network; with a
    gradient the correlation stays differentiable."""
    monkeypatch.setattr(fg, "CORR_CHUNK_BYTES", 4 * 4 * (H * W) ** 2)
    assert fg.corr_chunk(H, W) == 4
    a = _inputs()
    if grad:
        a["fmaps"] = a["fmaps"].float().requires_grad_(True)
    calls = _spy(monkeypatch)
    seen = []
    orig = model.update_step
    monkeypatch.setattr(model, "update_step",
                        lambda net, inp, corr, flow: seen.append(corr)
                        or orig(net, inp, corr, flow))
    corr_cuda.reset_launch_counts()
    with torch.set_grad_enabled(grad):
        out = _operator(model, a)
    assert [len(c[0]) for c in calls] == [4, 4, 1]
    pyr, ii_r, jj_r = fg.edge_frames(a["fmaps"], a["ii"], a["jj"])
    for k, (ii, jj, coords, c_out) in enumerate(calls):
        assert torch.equal(ii, ii_r[4 * k:4 * k + 4])
        assert torch.equal(jj, jj_r[4 * k:4 * k + 4])
        assert torch.equal(coords, out[6][4 * k:4 * k + 4])
    assert torch.equal(seen[0], torch.cat([c[3] for c in calls]))
    assert seen[0].shape == (9, 196, H, W) and seen[0].dtype == torch.float32
    assert corr_cuda.launches == {"alt_corr": 0}
    if grad:
        out[1].sum().backward()
        assert a["fmaps"].grad is not None
        assert float(a["fmaps"].grad.abs().sum()) > 0


def test_kernel_takes_cuda_tensors_without_gradient_only():
    """The dispatch looks at the device alone; the wrapper refuses CPU
    tensors, and refuses a graph before it looks at the device (the kernel
    has no backward: the trainer calls ops/corr.alt_corr itself)."""
    c = make_case("single")
    pyr, coords = c["pyr"], c["coords"]
    assert not corr_cuda.takes(coords)
    corr_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="want cuda"):
        corr_cuda.alt_corr(pyr, c["ii"], c["jj"], coords)
    coords.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        corr_cuda.alt_corr(pyr, c["ii"], c["jj"], coords)
    with torch.no_grad():
        with pytest.raises(ValueError, match="want cuda"):
            corr_cuda.alt_corr(pyr, c["ii"], c["jj"], coords)
    assert corr_cuda.launches == {"alt_corr": 0}


def test_corr_counters_count_each_call_and_launch(model, monkeypatch):
    """`n.corr.call` one an update_operator call; `n.corr.kernel` one a
    launch, here through a stand-in for the kernel (the plain version) that
    the dispatch is made to take."""
    a = _inputs(seed=1)
    t = profiling.PhaseTimers()
    profiling.set_current(t)
    try:
        plain = _operator(model, a)
        assert t.total["n.corr.call"] == 1 and "n.corr.kernel" not in t.total
        got = []

        def stand_in(pyr, ii, jj, coords, out_dtype):
            got.append(out_dtype)
            return corr_ops.alt_corr(pyr, ii, jj, coords)

        monkeypatch.setattr(corr_cuda, "takes", lambda coords: True)
        monkeypatch.setattr(corr_cuda, "alt_corr", stand_in)
        again = _operator(model, a, fg.edge_frames(a["fmaps"], a["ii"],
                                                   a["jj"]))
    finally:
        profiling.set_current(None)
    assert t.total["n.corr.call"] == 2 and t.count["n.corr.call"] == 2
    assert t.total["n.corr.kernel"] == 1 and t.count["n.corr.kernel"] == 1
    assert got == [model.dtype]       # the network's dtype, one launch
    for p, q in zip(plain, again):
        assert torch.equal(p, q)


def test_corr_kernel_pct_reads_its_counters():
    rec = lambda seconds: {"part": {"timers": {"seconds": seconds,
                                               "calls": {}}}}
    assert corr_kernel_pct.read(rec({"n.corr.call": 472,
                                     "n.corr.kernel": 472})) == 100.0
    assert corr_kernel_pct.read(rec({"n.corr.call": 8,
                                     "n.corr.kernel": 2})) == 25.0
    assert corr_kernel_pct.read(rec({"n.corr.call": 8})) == 0.0
    # a program without the counters (the parent), or a window without
    # the network (oracle tracking)
    assert corr_kernel_pct.read(rec({"n.dspo.iter": 3})) is None
    assert corr_kernel_pct.read(rec({"n.corr.call": 0})) is None


def test_kernel_bounds_arithmetic():
    """The loop round (E 169, P 25, 48 × 64): the bytes bound it (the
    pyramid once, the rows and targets once, the bf16 output once), ahead
    of the dot products on the tensor cores and the combine on the FP32
    units."""
    assert corr_cuda.level_sizes(48, 64) == [(48, 64), (24, 32), (12, 16),
                                             (6, 8)]
    assert corr_cuda.level_sizes(7, 13)[-1] == (0, 1)
    assert corr_cuda.DOT_OPS == 64 * 128 * 2
    assert corr_cuda.COMBINE_OPS == 28 * 5 + 49 * 9
    ms, by = corr_cuda.kernel_bounds(169, 25, 48, 64)
    nbytes = (25 * 128 * 4080 * 2 + 169 * 16 + 169 * 3072 * 8
              + 169 * 196 * 3072 * 2)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert 0.06 < ms < 0.08
    n = 169 * 3072 * 4
    assert n * 16384 / 989e12 * 1e3 == pytest.approx(0.0344, abs=1e-4)
    assert n * 581 / 67e12 * 1e3 == pytest.approx(0.0180, abs=1e-4)
    # a float32 output adds its bytes; one edge among many frames is bound
    # by reading their pyramid
    ms32, by32 = corr_cuda.kernel_bounds(169, 25, 48, 64, out_bytes=4)
    assert by32 == "bytes" and ms32 == pytest.approx(
        (nbytes + 169 * 196 * 3072 * 2) / 3.35e12 * 1e3)
    ms1, by1 = corr_cuda.kernel_bounds(1, 400, 48, 64)
    assert by1 == "bytes"
    assert ms1 == pytest.approx((400 * 128 * 4080 * 2 + 16 + 3072 * 8
                                 + 196 * 3072 * 2) / 3.35e12 * 1e3)
    # with the output and pyramid bytes gone, the tensor cores bound it
    ms0, by0 = corr_cuda.kernel_bounds(169, 0, 48, 64, out_bytes=0)
    assert by0 == "tensor operations"
    assert ms0 == pytest.approx(n * 16384 / 989e12 * 1e3)
