"""Config system: recursive YAML inheritance (counterpart of
splatslam_tpu/config.py). Scene yaml → (inherit_from chains) →
configs/splat_slam.yaml, with the same keys.
"""

from __future__ import annotations

import os

import yaml


def load_config(path: str, default_path: str | None = None) -> dict:
    """Load a config and merge its full `inherit_from` chain."""
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f)
    inherit = cfg_special.get("inherit_from")
    if inherit is not None:
        cfg = load_config(inherit, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f)
    else:
        cfg = {}
    update_recursive(cfg, cfg_special)
    return cfg


def update_recursive(dict1: dict, dict2: dict) -> None:
    """In-place recursive dict merge (dict2 wins)."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else None
        if isinstance(v, dict):
            if not isinstance(dict1[k], dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def save_config(cfg: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.dump(cfg, f)
