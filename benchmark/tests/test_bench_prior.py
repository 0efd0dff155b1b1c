"""The prior's checked stage (stages/prior.py), its FLOP term and its two
metric readers, on the CPU at a tiny size: `prior_gap` reads the
program's DPT pass within the cell's limit and turns `correct` false under
each fault of the network a port could have, and under a network or an
input cut from the published ones; the readers return None on a
record without the program's span and counter; one tiny traced run of
`prior.orbit` through the harness (the network at its published widths on
64x64 inputs)."""

import pytest
import torch
import torch.nn.functional as F

from benchmark import check, harness, probes, stages
from benchmark.flop_terms.prior import dpt_pass
from benchmark.reference import dpt as ref_dpt
from benchmark.stages import prior as prior_stage
from benchmark.tests import tiny
from splatslam_tpu_torch.models import dpt

SIZE = 64


@pytest.fixture(scope="module")
def model():
    return dpt.init_seeded(dpt.DPTDepthModel()).eval()


@pytest.fixture
def small_input(monkeypatch):
    """The published network on a SIZE² input: the published 512² is
    minutes a pass on the CPU. Every width and block stays published."""
    monkeypatch.setattr(ref_dpt, "INPUT", (1, 3, SIZE, SIZE))


def _limits():
    return harness.load_cell("prior.orbit")["workload"]["limits"]


def _judge(model, x):
    """(correct, prior_gap) of one captured pass of `model` on `x`."""
    p = probes.Patches()
    got = {}
    try:
        prior_stage.arm(probes.Slot(got, "prior", None), p)
        with torch.no_grad():
            model(x)
    finally:
        p.remove()
    ctx = stages.Context(None, None, "cpu", None)
    values, _ = check.readings(got, ctx, [prior_stage])
    limits = {"prior_gap": _limits()["prior_gap"]}
    correct, _ = check.judge(values, limits)
    return correct, values["prior_gap"]


def _x(size=SIZE):
    return torch.randn(1, 3, size, size,
                       generator=torch.Generator().manual_seed(3))


def test_the_program_reads_correct(small_input, model):
    correct, gap = _judge(model, _x())
    assert correct and gap < 1e-4, gap


def _skip_block(monkeypatch, model):
    blk = model.pretrained.model.blocks[5]
    monkeypatch.setattr(blk, "forward", lambda x: x)


def _attention_scale(monkeypatch, model):
    sdpa = F.scaled_dot_product_attention
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda q, k, v: sdpa(q, k, v, scale=1.0 / 4.0))


def _groups(monkeypatch, model):
    for m in model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            monkeypatch.setattr(m, "num_groups", 16)


@pytest.mark.parametrize("fault", [_skip_block, _attention_scale, _groups],
                         ids=["one ViT block skipped", "attention scale",
                              "GroupNorm over 16 groups"])
def test_a_fault_reads_incorrect(small_input, monkeypatch, model, fault):
    fault(monkeypatch, model)
    correct, gap = _judge(model, _x())
    assert not correct, gap


def _narrow_hook():
    return dpt.DPTDepthModel(reassemble=(256, 512, 384, 768))


def _eleven_blocks():
    """Block 11 dropped: its hook reads block 10's output."""
    m = dpt.DPTDepthModel(num_blocks=11)
    m.pretrained.model.blocks.append(torch.nn.Identity())
    return m


@pytest.mark.parametrize("build", [_narrow_hook, _eleven_blocks],
                         ids=["block 8 reassembled at 384", "11 blocks"])
def test_a_cut_network_reads_incorrect(small_input, build):
    """The reference reads its widths from the weights it is given, so it
    would agree with a cut network: the stage holds the capture to the
    published one."""
    cut = dpt.init_seeded(build()).eval()
    correct, gap = _judge(cut, _x())
    assert not correct and gap == float("inf"), gap


def test_a_smaller_input_reads_incorrect(model):
    """The published network on a 384² input in place of the 512²."""
    correct, gap = _judge(model, _x(384))
    assert not correct and gap == float("inf"), gap


def _rec(seconds, flops_by_kind=None, peak=989.4e12):
    return dict(part=dict(window_s=20.0, frames=10,
                          timers=dict(seconds=seconds, calls={})),
                flops_by_kind=flops_by_kind or {}, peak_flops=peak)


@pytest.mark.parametrize("rec", [
    _rec({}),
    _rec({"mono": 3.0, "mono.dpt": 0.0}),
    _rec({"mono.dpt": 1.0, "n.mono.dpt": 0}),
])
def test_the_readers_read_nothing_without_the_counters(rec):
    assert harness.read_metric("prior_ms_per_pass", rec) is None
    assert harness.read_metric("prior_mfu", rec) is None


def test_the_readers_on_a_hand_built_record():
    rec = _rec({"mono.dpt": 0.8, "n.mono.dpt": 20},
               {"tracking": 1e12, "prior": 20 * 4.7e11})
    assert harness.read_metric("prior_ms_per_pass", rec) == pytest.approx(
        40.0)
    peak = 132 * 128 * 2 * 1.98e9
    assert harness.read_metric("prior_mfu", rec) == pytest.approx(
        100.0 * 20 * 4.7e11 / 0.8 / peak)
    # a run on no card the benchmark knows: no share of a peak
    rec["peak_flops"] = None
    assert harness.read_metric("prior_mfu", rec) is None


def _small_predictor(monkeypatch):
    """The prior's predictor at a SIZE² input (the published 512² is
    minutes a pass on the CPU); the network keeps its widths."""
    init = dpt.DPTDepthPredictor.__init__
    monkeypatch.setattr(
        dpt.DPTDepthPredictor, "__init__",
        lambda self, ckpt_path=None, size=512, device=None: init(
            self, ckpt_path, SIZE, device))


def test_a_traced_cpu_run_of_the_prior_cell(small_input, monkeypatch):
    """prior.orbit shrunk (tiny.shrink, the network on 64x64 inputs),
    traced on the CPU: every limited number is read and within its limit,
    prior_ms_per_pass is read from the program's span, the prior's FLOPs
    enter the window's count, and prior_mfu reads nothing off a card."""
    _small_predictor(monkeypatch)
    got = {}
    read = harness.read_metric

    def keep(name, rec):
        got["rec"] = rec
        return read(name, rec)

    monkeypatch.setattr(harness, "read_metric", keep)
    r = harness.run("prior.orbit", 7, 3.0, True, "cpu",
                    overrides=tiny.shrink)
    v = {k: row["value"] for k, row in r["checks"].items()}
    assert r["correct"], v
    assert set(v) == set(_limits())
    m = {k: row["value"] for k, row in r["metrics"].items()}
    assert m["prior_ms_per_pass"] > 0 and "prior_mfu" not in m, m
    rec = got["rec"]
    passes = rec["part"]["timers"]["seconds"]["n.mono.dpt"]
    assert passes >= 1
    assert rec["flops_by_kind"]["prior"] == pytest.approx(
        passes * dpt_pass(1, SIZE, SIZE))
