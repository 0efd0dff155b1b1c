"""The checked stages as files (stages/): moved from one module into a
file each, they read what they read before, on stored captures.

`data/captures_seed7.pt` holds the captures of one tiny CPU run of
`learned.orbit` at seed 7 (`fixture_config`: tiny.shrink at 64x96 frames,
chunks of 2, 8 factors; a float32 network), cut down to what the numbers
read: the map's alive rows, the update operator's outputs that its number
compares. Remake it with `python -m benchmark.tests.test_bench_stages
<path>`; the values below are then read again with `check.readings` of
commit 1a232d8, which took the tracker network in place of a context.
"""

import os
import sys

import pytest
import torch

from benchmark import check, harness, scene, stages
from benchmark.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "captures_seed7.pt")
SEED = 7

# check.readings of commit 1a232d8 (the stages' one module before the
# move) on the fixture's captures, on the CPU
PARENT = {
    "scan_gap": 1.655419339385844e-07,
    "update_gap": 0.0003951284452341497,
    "dba_gap": 9.746024716150714e-07,
    "render_gap": 0.0,
    "step_gap": 1.2982565441577125e-08,
}


def fixture_config(cfg, spec):
    """The fixture's run: tiny.shrink cut further, its limits the
    numbers of the parent's stages."""
    tiny.shrink(cfg, spec)
    cfg["cam"].update(H=64, W=96, fx=160 / 3, fy=160 / 3, cx=47.5, cy=31.5,
                      H_out=64, W_out=96)
    cfg["mapping"].update(capacity=1024)
    cfg["mapping"]["Training"].update(window_size=3)
    cfg["tracking"]["frontend"].update(max_factors=8)
    cfg["tracking"]["motion_filter"]["batch"] = 2
    spec["workload"]["limits"] = {n: spec["workload"]["limits"][n]
                                  for n in PARENT}


def _frames():
    spec = harness.load_cell("learned.orbit")
    cfg = harness.slam_config(spec, "unused")
    fixture_config(cfg, spec)
    images, _, _ = scene.render_frames(cfg, SEED, spec["workload"]["n_frames"],
                                       spec["traffic"]["motion_scale"])
    return cfg, images


def test_moved_stages_read_as_before():
    got = torch.load(FIXTURE, weights_only=True)
    got["update"]["timestamps"] = got["update"]["timestamps"].numpy()
    cfg, frames = _frames()
    ctx = stages.Context(cfg, frames, "cpu",
                         os.path.join(harness.ROOT, harness.CHECKPOINT))
    values, _ = check.readings(got, ctx, stages.for_limits(PARENT))
    assert set(values) == set(PARENT)
    for n, v in PARENT.items():
        assert values[n] == pytest.approx(v, rel=1e-9, abs=0.0), n


def make_fixture(path):
    """Run the cell once at the fixture's size and store its captures."""
    os.environ["SPLATSLAM_F32_NET"] = "1"
    got = {}
    readings = check.readings

    def keep(g, ctx, s):
        got.update(g)
        return readings(g, ctx, s)

    check.readings = keep
    try:
        harness.run("learned.orbit", SEED, 3.0, False, "cpu",
                    overrides=fixture_config)
    finally:
        check.readings = readings
    up = got["update"]
    up["timestamps"] = torch.as_tensor(up["timestamps"])
    # the upsampling mask and the sixth output are not compared
    up["out"] = tuple(None if i in (4, 5) else t
                      for i, t in enumerate(up["out"]))
    m = got["map"]
    rows = m["alive"]
    for k in ("params", "m", "v", "grads", "post"):
        m[k] = {n: t[rows] for n, t in m[k].items()}
    m["alive"] = rows[rows]
    torch.save(got, path)


if __name__ == "__main__":
    make_fixture(sys.argv[1])
