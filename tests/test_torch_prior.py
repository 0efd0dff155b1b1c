"""The omnidata DPT-Hybrid prior of the port against the benchmark's plain
reference (benchmark/reference/dpt.py), on seeded full-width weights on
the CPU, and the prior's spans and counters in a tiny `dpt` run.

  1. the port's DPTDepthModel (float32) against the reference in float64
     on `init_seeded` weights at 64x64 and 64x96 (a 4x6 token grid: the
     positional embedding is resized from 24x24 to a non-square grid).
     Tolerance: 5e-5 relative L2 over the output map. Float32 through a
     30-convolution stem, twelve transformer blocks and the decoder reads
     4.7-6.2e-6 here (the reference itself in float32 reads the same), so
     the bound leaves rounding ~10x room while a fault of the network (a
     block skipped, a wrong attention scale or GroupNorm grouping) reads
     3e-2 or more (benchmark/tests/test_bench_prior.py);
  2. the reference imports neither JAX nor the port;
  3. the benchmark's FLOP term for the prior (flop_terms/prior.py) against
     torch.utils.flop_counter.FlopCounterMode run on the reference: both
     count convolutions and matrix products (2 FLOPs a multiply-add,
     biases and elementwise work left out), so they agree exactly;
  4. the port's default DPTDepthModel holds the published network: every
     tensor's name and shape as the reference's table of it
     (`departures` empty on a 512x512 input), and the JAX package's
     widths (block 8 at 384) depart from it;
  5. a tiny SLAM run with the `dpt` provider (the network at its widths,
     on 64x64 inputs) records the spans `mono.dpt` and `mono.save` and the
     counters `n.mono.dpt` (one a pass) and `n.dspo.bad_mono` /
     `n.dspo.frames` (stage 2's dropped and fitted depth frames), beside
     the phase `mono`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.flop_terms.prior import dpt_pass
from benchmark.reference import dpt as ref_dpt
from splatslam_tpu_torch.models import dpt
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-5


@pytest.fixture(scope="module")
def model():
    return dpt.init_seeded(dpt.DPTDepthModel()).eval()


def _x(hw):
    return torch.randn(1, 3, *hw, generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_port_matches_the_plain_reference(model, hw):
    x = _x(hw)
    sd = {k: v.double() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(x).double()
        want = ref_dpt.forward(sd, x.double())
    assert got.shape == want.shape == (1, *hw)
    # the head's last ReLU is open: the comparison sees the network
    assert float((want > 0).double().mean()) > 0.5 and float(want.std()) > 0
    rel = float((got - want).norm() / want.norm())
    print(f"{hw}: relative L2 {rel:.3e}")
    assert rel <= TOL, rel


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import benchmark.reference.dpt; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'splatslam_tpu', "
            "'splatslam_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (128, 96)])
def test_the_flop_term_counts_what_flop_counter_mode_counts(model, hw):
    sd = dict(model.state_dict())
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref_dpt.forward(sd, _x(hw))
    assert fc.get_total_flops() == dpt_pass(1, *hw)


def test_the_default_model_is_the_published_network():
    with torch.device("meta"):
        published = dpt.DPTDepthModel()
        jax_widths = dpt.DPTDepthModel(reassemble=(256, 512, 384, 768))
    assert ref_dpt.departures(published.state_dict(), ref_dpt.INPUT) == []
    assert ref_dpt.departures(jax_widths.state_dict(), ref_dpt.INPUT)


def test_spans_and_counters_of_a_tiny_dpt_run(tmp_path, monkeypatch):
    from test_torch_mono_prior import _tiny_cfg
    from splatslam_tpu_torch.slam import SLAM
    init = dpt.DPTDepthPredictor.__init__
    monkeypatch.setattr(
        dpt.DPTDepthPredictor, "__init__",
        lambda self, ckpt_path=None, size=512, device=None: init(
            self, ckpt_path, 64, device))
    monkeypatch.chdir(REPO)
    cfg = _tiny_cfg(tmp_path / "out", "dpt")
    cfg["tracking"]["mono_thres"] = 0.1         # the source's bad-mono test
    slam = SLAM(cfg, device="cpu")
    slam.run()
    t, n = slam.timers.total, slam.timers.count
    passes = slam.mono._dpt.calls
    assert passes >= 5
    assert t["n.mono.dpt"] == n["mono.dpt"] == passes
    assert t["mono.dpt"] > 0
    # a saved map a pass; the phase `mono` times every request, hits too
    saved = [f for f in os.listdir(tmp_path / "out" / "prior" / "mono_priors"
                                   / "depths") if f.endswith(".npy")]
    assert n["mono.save"] == len(saved) == passes
    assert n["mono"] > passes
    assert 0 <= t["n.dspo.bad_mono"] <= t["n.dspo.frames"]
    assert n["n.dspo.bad_mono"] == n["n.dspo.frames"] >= 1
    assert np.isfinite(t["mono.save"])
