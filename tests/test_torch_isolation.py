"""The port stands alone: importing every module of splatslam_tpu_torch
loads neither jax nor the JAX package, and its entry point refuses to run
on a machine without a GPU unless the caller names the device."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import splatslam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [k for k in ("jax", "splatslam_tpu") if k in sys.modules]
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


def test_run_without_device_raises_when_no_gpu(monkeypatch):
    from splatslam_tpu_torch import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml")])


@pytest.mark.parametrize("edit,match", [
    (("tracking", "oracle", False), "learned tracker: not ported yet"),
    (("mono_prior", "provider", "dpt"), "not ported yet"),
    (("dataset", None, "replica"), "not ported yet"),
])
def test_configs_outside_the_slice_fail_loudly(edit, match, monkeypatch):
    monkeypatch.chdir(REPO)
    from splatslam_tpu_torch.config import load_config
    from splatslam_tpu_torch.slam import check_slice
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/smoke_oracle.yaml"),
                      os.path.join(REPO, "configs/splat_slam.yaml"))
    sec, key, val = edit
    if key is None:
        cfg[sec] = val
    else:
        cfg[sec][key] = val
    with pytest.raises(NotImplementedError, match=match):
        check_slice(cfg)
