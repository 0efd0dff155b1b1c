"""The traffic generator reproduces the program's Synthetic frames for
seed 7, in both configurations' cameras."""

import json
import os

import numpy as np
import pytest

from benchmark import scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("config", ["synthetic_learned", "replica_scale"])
@pytest.mark.parametrize("motion_scale", [5.0, 1.0])
def test_seed_7_is_synthetic(config, motion_scale):
    from splatslam_tpu_torch.datasets import Synthetic
    with open(os.path.join(ROOT, "benchmark/configs", config + ".json")) as f:
        cfg = json.load(f)["slam"]
    cfg = dict(cfg, synthetic=dict(n_frames=6, seed=7,
                                   motion_scale=motion_scale), max_frames=6)
    ref = Synthetic(cfg)
    images, depths, c2w = scene.render_frames(cfg, 7, 6, motion_scale)
    for k in range(6):
        _, img, dep, pose = ref[k]
        assert np.array_equal(img, images[k])
        assert np.array_equal(dep, depths[k])
        assert np.array_equal(pose, c2w[k])


def test_seeds_differ_and_repeat():
    cfg = {"cam": dict(H=48, W=64, H_out=48, W_out=64, fx=40.0, fy=40.0,
                       cx=31.5, cy=23.5)}
    a = scene.render_frames(cfg, 2 ** 31 + 5, 2, 5.0)[0]
    b = scene.render_frames(cfg, 2 ** 31 + 5, 2, 5.0)[0]
    c = scene.render_frames(cfg, 2 ** 31 + 6, 2, 5.0)[0]
    assert np.array_equal(a, b) and not np.array_equal(a, c)
