"""The bench scene the checkpoint tools measure on: smoke geometry at
240x320, fx 200, motion_scale 5, 60 frames (tools/flow_probe.py:38-48 of the
JAX repository, the workload bench.py tracks)."""

from __future__ import annotations

import copy

SCENE_CFG = {
    "dataset": "synthetic",
    "cam": {"H": 240, "W": 320, "fx": 200.0, "fy": 200.0, "cx": 159.5,
            "cy": 119.5, "H_out": 240, "W_out": 320, "H_edge": 0,
            "W_edge": 0},
    "synthetic": {"n_frames": 60, "seed": 7, "motion_scale": 5.0},
}
DEFAULT_CKPT = "pretrained/droid_dba.msgpack"


def scene_cfg():
    return copy.deepcopy(SCENE_CFG)
