"""DSPO stage 2's kernels (csrc/dspo.cu) seen from the CPU: the dispatch of
`ops/ba._scale_shift_iteration` and `tracking/depth_video.depth_filter` to
their plain versions for CPU tensors, bit for bit as before (the benchmark's
frozen copy of the stage-2 iteration), no kernel launch on the CPU, the
wrappers' refusals, the per-frame edge order the kernel walks, the counters
`n.dspo.iter` / `n.dspo.kernel` and the metric `dspo_kernel_pct` that reads
them. The kernels against the plain versions on the card:
tests/test_torch_cuda.py."""

import pytest
import torch

from benchmark.metrics import dspo_kernel_pct
from benchmark.reference import ba as ref_ba, dspo as ref_dspo
from dspo_cases import CASES, FILTER_CASES, make_filter_problem, make_problem
from splatslam_tpu_torch.ops import ba, dspo_cuda
from splatslam_tpu_torch.tracking import depth_video as dv
from splatslam_tpu_torch.utils import profiling
from test_torch_threads import few_torch_threads  # noqa: F401

KEYS = ("poses", "disps", "intrinsics", "target", "weight", "eta",
        "mono_disps", "scales", "shifts", "valid_depth_mask", "edges", "lm",
        "ep", "alpha")


def _args(p):
    return [p[k] for k in KEYS]


@pytest.mark.parametrize("name", CASES)
def test_scale_shift_iteration_on_the_cpu_is_the_plain_version(name):
    p = make_problem(name)
    dspo_cuda.reset_launch_counts()
    got = ba._scale_shift_iteration(*_args(p), kx_mask=p["kx_mask"])
    plain = ba._scale_shift_iteration_torch(*_args(p), kx_mask=p["kx_mask"])
    e = p["edges"]
    ref_edges = ref_ba.make_edges(e.ii, e.jj, e.t0, e.t1, e.ii.device)
    frozen = ref_dspo.scale_shift_iteration(
        *_args(p)[:10], ref_edges, p["lm"], p["ep"], p["alpha"],
        p["kx_mask"])
    for g, q, f in zip(got, plain, frozen):
        assert torch.equal(g, q) and torch.equal(g, f)
    # the iteration moved the state, and a frame it rejects keeps its own
    kx = e.kx
    moved = got[1][kx] != p["scales"][kx]
    assert moved.any()
    if name == "nonfinite":
        k = int(e.kk[7])
        assert not moved[k]
        assert torch.equal(got[0][kx[k]], p["disps"][kx[k]])
    assert dspo_cuda.launches == {"scale_shift_iteration": 0,
                                  "depth_filter": 0}


@pytest.mark.parametrize("name", FILTER_CASES)
def test_depth_filter_on_the_cpu_is_the_plain_version(name):
    f = make_filter_problem(name)
    dspo_cuda.reset_launch_counts()
    args = (f["poses"], f["disps"], f["intrinsics"], f["inds"], f["thresh"])
    got = dv.depth_filter(*args)
    assert torch.equal(got, dv.depth_filter_torch(*args))
    counts = torch.bincount(got.flatten().long(), minlength=7)
    assert got.shape == (len(f["inds"]),) + tuple(f["disps"].shape[1:])
    assert (counts > 0).all(), counts      # 0 to 6 agreeing neighbours
    assert dspo_cuda.launches["depth_filter"] == 0


def test_kernel_wrappers_take_cuda_tensors_only():
    p = make_problem("hard")
    f = make_filter_problem("eighth")
    dspo_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="want cuda"):
        dspo_cuda.scale_shift_iteration(*_args(p), p["kx_mask"])
    with pytest.raises(ValueError, match="want cuda"):
        dspo_cuda.depth_filter(f["poses"], f["disps"], f["intrinsics"],
                               f["inds"], f["thresh"])
    # no path differentiates stage 2: the kernel refuses a graph
    p["disps"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        dspo_cuda.scale_shift_iteration(*_args(p), p["kx_mask"])
    assert dspo_cuda.launches == {"scale_shift_iteration": 0,
                                  "depth_filter": 0}


@pytest.mark.parametrize("name", ["loop", "hard"])
def test_edges_by_frame_lists_each_frames_edges_in_order(name):
    e = make_problem(name)["edges"]
    order, offsets = e.by_frame()
    assert e.by_frame()[0] is order          # made once per edge set
    assert offsets.shape == (e.M + 1,) and int(offsets[-1]) == len(e.ii)
    for k in range(e.M):
        run = order[offsets[k]:offsets[k + 1]]
        assert torch.equal(run, (e.kk == k).nonzero()[:, 0]), k


def test_stage2_counters_count_each_iteration():
    p = make_problem("hard")
    t = profiling.PhaseTimers()
    profiling.set_current(t)
    try:
        ba._scale_shift_iteration(*_args(p), kx_mask=p["kx_mask"])
        ba.ba_scale_shift(*_args(p)[:11], iters=3)
    finally:
        profiling.set_current(None)
    assert t.total["n.dspo.iter"] == 4 and t.count["n.dspo.iter"] == 4
    assert "n.dspo.kernel" not in t.total      # no launch on the CPU


def test_dspo_kernel_pct_reads_its_counters():
    rec = lambda seconds: {"part": {"timers": {"seconds": seconds,
                                               "calls": {}}}}
    assert dspo_kernel_pct.read(rec({"n.dspo.iter": 48,
                                     "n.dspo.kernel": 48})) == 100.0
    assert dspo_kernel_pct.read(rec({"n.dspo.iter": 8,
                                     "n.dspo.kernel": 2})) == 25.0
    assert dspo_kernel_pct.read(rec({"n.dspo.iter": 8})) == 0.0
    # a program without the counters, or a window without stage 2
    assert dspo_kernel_pct.read(rec({"n.map.graphed": 3})) is None
    assert dspo_kernel_pct.read(rec({"n.dspo.iter": 0})) is None
