"""The port's checkpoint tools against the JAX repository's tools
(tools/flow_probe.py, tools/admission_calib.py, tools/ate_matrix.py).

The JAX tools hard-code their 240x320 scene inside main(), so the fast
tests compose the JAX side from the JAX package's functions, the same calls
in the same order, on a shrunk scene; both networks in float32 on the
in-repo checkpoint:
- the flow probe's numbers per pair (EPE, GT flow, first_delta, magnitude
  bias) at 96x128 within 1e-3 relative;
- the admission chain at 88x120 over 16 frames, at two thresholds: the
  same admitted frames, deltas within 1e-3 relative;
- one ate_matrix arm on the shrunk only-tracking config: the same
  keyframes and kf-ATE within 1e-3 of the JAX run.
The arms, the `_iters` arm and the SPLATSLAM_CKPT override are held to the
JAX tool's own. A slow test runs the JAX flow probe's and admission
calibration's main() and the port's tools at full size and diffs the
printed lines.

The admission scene is 88x120, a size no other test traces: the JAX motion
filter's jitted functions read SPLATSLAM_F32_NET when they trace, so a
program compiled at a shared size in bf16 could be handed to this file.
"""

import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu_torch.tools import admission_calib as t_adm
from splatslam_tpu_torch.tools import ate_matrix as t_ate
from splatslam_tpu_torch.tools import flow_probe as t_fp
from splatslam_tpu_torch.tools._scene import scene_cfg
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "pretrained/droid_dba.msgpack")
sys.path.insert(0, os.path.join(REPO, "tools"))


@pytest.fixture(scope="module", autouse=True)
def f32_net():
    old = os.environ.get("SPLATSLAM_F32_NET")
    os.environ["SPLATSLAM_F32_NET"] = "1"
    yield
    if old is None:
        os.environ.pop("SPLATSLAM_F32_NET", None)
    else:
        os.environ["SPLATSLAM_F32_NET"] = old


def _scene(H, W, n):
    cfg = scene_cfg()
    cfg["cam"].update(H=H, W=W, H_out=H, W_out=W, fx=80.0, fy=80.0,
                      cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)
    cfg["synthetic"]["n_frames"] = n
    return cfg


def _jax_probe_pair(params, img1, img2, disp8, pose1, pose2, intr8):
    """tools/flow_probe.py's epe_pair, its calls in its order, at the size
    of disp8."""
    from splatslam_tpu.models.droid_net import DroidNet, normalize_images
    from splatslam_tpu.ops import corr as corr_ops
    from splatslam_tpu.ops import projective as pops
    model = DroidNet()
    h, w = disp8.shape
    coords0 = pops.coords_grid(h, w)
    x = normalize_images(jnp.stack([img1, img2]))
    fmaps = model.apply({"params": params}, x, method=DroidNet.features)
    cn, ci = model.apply({"params": params}, normalize_images(img1[None]),
                         method=DroidNet.context)
    pyr = corr_ops.build_corr_pyramid(fmaps[:1].astype(jnp.float32),
                                      fmaps[1:].astype(jnp.float32))
    poses = jnp.stack([pose1, pose2])
    ii = jnp.asarray([0], jnp.int32)
    jj = jnp.asarray([1], jnp.int32)
    gt, valid = pops.projective_transform(
        poses[None], disp8[None][None].repeat(2, 1),
        intr8[None][None].repeat(2, 1), ii, jj)
    gt = gt[0, 0]
    valid = valid[0, 0][..., 0]
    net = cn
    coords = jnp.broadcast_to(coords0, (1, h, w, 2))
    first_delta = None
    for _ in range(8):
        corr = corr_ops.lookup_pyramid(pyr, coords)
        motn = jnp.concatenate([jnp.clip(coords - coords0, -64, 64),
                                jnp.zeros_like(coords)], -1)
        net, delta, _wgt = model.apply({"params": params}, net, ci, corr,
                                       motn, method=DroidNet.update_step)
        if first_delta is None:
            first_delta = jnp.linalg.norm(delta.astype(jnp.float32),
                                          axis=-1).mean()
        coords = coords + delta.astype(jnp.float32)
    err = jnp.linalg.norm(coords[0] - gt, axis=-1) * valid
    gtmag = jnp.linalg.norm(gt - coords0, axis=-1) * valid
    estmag = jnp.linalg.norm(coords[0] - coords0, axis=-1) * valid
    bias = (estmag - gtmag).sum() / jnp.clip(valid.sum(), 1)
    return (err.sum() / jnp.clip(valid.sum(), 1),
            gtmag.sum() / jnp.clip(valid.sum(), 1), first_delta, bias)


def test_flow_probe_pairs_match_jax():
    from splatslam_tpu.datasets import Synthetic as JSynthetic
    from splatslam_tpu.ops import lie as jlie
    from splatslam_tpu.train.droid_trainer import load_selftrained
    from splatslam_tpu_torch.datasets import Synthetic
    cfg = _scene(96, 128, 16)
    ds, ds_j = Synthetic(cfg), JSynthetic(cfg)
    params = load_selftrained(CKPT)
    model = t_fp.load_model(CKPT, "cpu")
    assert model.dtype == torch.float32 and not model.training
    intr8 = np.asarray(ds.get_intrinsic(), np.float32) / 8.0
    pair = jax.jit(_jax_probe_pair)
    for k0, gap in ((2, 1), (5, 3), (7, 8)):
        got = t_fp.probe_pair(model, *t_fp.pair_inputs(ds, k0, gap, intr8))
        _, im1, d1, c1 = ds_j[k0]
        _, im2, _, c2 = ds_j[k0 + gap]
        d8 = d1[3::8, 3::8][:12, :16]
        disp8 = np.where(d8 > 1e-6, 1.0 / np.maximum(d8, 1e-6), 0.0)
        want = pair(params, jnp.asarray(im1), jnp.asarray(im2),
                    jnp.asarray(disp8),
                    jlie.from_matrix(jnp.asarray(np.linalg.inv(c1))),
                    jlie.from_matrix(jnp.asarray(np.linalg.inv(c2))),
                    jnp.asarray(intr8))
        want = [float(v) for v in want]
        print(k0, gap, "port", got, "jax", want)
        assert got[1] > 0.2                # the pair has real motion
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    line = t_fp.format_line(1, 2.5, 0.25, 1.5, -0.125)
    assert line == ("gap 1: gt_flow   2.50 px  epe  0.250 px  "
                    "first_delta  1.50 px  mag_bias -0.125 px")


def test_admission_matches_jax():
    from splatslam_tpu.datasets import Synthetic as JSynthetic
    from splatslam_tpu.train.droid_trainer import load_selftrained
    from splatslam_tpu.tracking.motion_filter import (
        encode_features, encode_context, track_kernel)
    from splatslam_tpu_torch.datasets import Synthetic
    cfg = _scene(88, 120, 16)
    params = load_selftrained(CKPT)
    ds_j = JSynthetic(cfg)
    frames_j = [jnp.asarray(np.asarray(ds_j[i][1])) for i in range(len(ds_j))]
    model = t_adm.load_model(CKPT, "cpu")
    assert model.dtype == torch.float32        # SPLATSLAM_F32_NET
    frames = t_adm.scene_frames(Synthetic(cfg), "cpu")
    assert len(frames) == 16
    ths = (0.8, 1.4)
    got = {th: t_adm.admission(model, frames, th) for th in ths}
    for th in ths:
        # tools/admission_calib.py's loop
        fmap = encode_features(params, frames_j[0])
        net, inp = encode_context(params, frames_j[0])
        admitted, deltas = [0], []
        for i in range(1, len(frames_j)):
            gmap, dmag = track_kernel(params, frames_j[i], fmap, net, inp)
            d = float(dmag)
            deltas.append(d)
            if d > th:
                admitted.append(i)
                fmap = gmap
                net, inp = encode_context(params, frames_j[i])
        print(th, got[th][0], admitted)
        assert got[th][0] == admitted
        np.testing.assert_allclose(got[th][1], deltas, rtol=1e-3)
    # the thresholds split the scene differently: decisions really compared
    assert got[ths[0]][0] != got[ths[1]][0]
    assert 2 < len(got[ths[1]][0]) < len(got[ths[0]][0]) < 16
    line = t_adm.format_line(1.4, [0, 2, 5], [1.0, 2.0, 0.5, 1.0, 3.0], 60)
    assert line == ("thresh 1.40: admitted 3/60  median_gap 2.5  "
                    "delta p10/p50/p90 0.70/1.00/2.60")


def test_arms_match_the_jax_tool():
    import ate_matrix as j_ate
    assert t_ate.ARMS == j_ate.ARMS


def test_arm_config_matches_the_jax_tool(monkeypatch):
    """The base config and each arm's overrides as the JAX tool builds them
    (its output folder aside), SPLATSLAM_CKPT included."""
    import ate_matrix as j_ate
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("SPLATSLAM_CKPT", "some/other.msgpack")
    want = j_ate.base_cfg()
    assert want["tracking"]["pretrained"] == "some/other.msgpack"
    assert t_ate.base_cfg() == want
    captured = {}

    class FakeSLAM:
        def __init__(self, cfg, device=None):
            captured["cfg"] = cfg
            self.frontend = type("F", (), {})()
            self.video = type("V", (), {"counter": 3})()

        def run(self):
            captured["iters"] = (self.frontend.__dict__.get("iters1"),
                                 self.frontend.__dict__.get("iters2"))
            return {"ate_rmse": 0.5}

    import splatslam_tpu_torch.slam as slam_mod
    monkeypatch.setattr(slam_mod, "SLAM", FakeSLAM)
    for name, ov in t_ate.ARMS.items():
        assert t_ate.run_arm(name, ov, device="cpu", out="o") == (0.5, 3)
        cfg = j_ate.base_cfg()
        for k, v in ov.items():
            if k != "_iters":
                d = cfg
                for part in k[:-1]:
                    d = d[part]
                d[k[-1]] = v
        cfg["data"]["output"] = os.path.join("o", name)
        assert captured["cfg"] == cfg, name
        assert captured["iters"] == (ov.get("_iters") or (None, None))


def test_ate_matrix_arm_matches_jax(tmp_path, monkeypatch, capsys):
    """The `noba` arm on test_torch_slam's shrunk learned config, tracking
    only: the port's run_arm against the JAX SLAM run of the same arm."""
    from test_torch_slam import _cfg
    from splatslam_tpu.slam import SLAM as JSLAM
    monkeypatch.chdir(REPO)

    def shrunk(out):
        cfg = _cfg(out, learned=True)
        cfg.update(only_tracking=True, eval_full_traj=False)
        return cfg

    cfg_j, _ = t_ate.arm_cfg("noba", t_ate.ARMS["noba"],
                             shrunk(tmp_path / "jax"), str(tmp_path / "jax"))
    assert not cfg_j["tracking"]["frontend"]["enable_loop"]
    slam_j = JSLAM(cfg_j)
    ate_j = slam_j.run()["rmse"]
    capsys.readouterr()
    rmse, n_kf = t_ate.run_arm("noba", t_ate.ARMS["noba"], device="cpu",
                               cfg=shrunk(tmp_path / "t"),
                               out=str(tmp_path / "t"))
    assert f"\nARM noba     kf_ate {rmse}  n_kf {n_kf}\n" in \
        "\n" + capsys.readouterr().out
    print("port", rmse, n_kf, "jax", ate_j, slam_j.video.counter)
    assert n_kf == slam_j.video.counter >= 5
    assert abs(rmse - ate_j) <= 1e-3


def _lines(cmd, env):
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=7200)
    assert res.returncode == 0, res.stdout + res.stderr
    return [ln for ln in res.stdout.splitlines()
            if re.match(r"^(gap|thresh|ARM) ", ln)]


def _numbers(line):
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?",
                                         line)]


@pytest.mark.slow
@pytest.mark.parametrize("tool,args", [
    ("flow_probe", []), ("admission_calib", [])])
def test_port_tool_prints_the_jax_tools_lines(tool, args):
    """Each JAX tool's main() and the port's tool at full size, float32, on
    the CPU: the same lines, numbers within 1e-3 relative (admission counts
    exact). ate_matrix is held by test_ate_matrix_arm_matches_jax: the JAX
    tool writes its arms under a fixed path outside the checkout."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, SPLATSLAM_F32_NET="1", JAX_PLATFORMS="cpu")
    want = _lines([sys.executable, f"tools/{tool}.py", *args], env)
    got = _lines([sys.executable, "-m", f"splatslam_tpu_torch.tools.{tool}",
                  *args, "--device", "cpu"], env)
    print("\n".join(want + got))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert re.sub(r"[-+]?\d+\.\d+", "#", g) == \
            re.sub(r"[-+]?\d+\.\d+", "#", w)
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.slow
def test_port_ate_matrix_arm_prints_the_jax_tools_line(tmp_path, monkeypatch,
                                                        capsys):
    """The `base` arm at full size, float32, on the CPU: the JAX tool's
    run_arm composed in-process from its base_cfg() (its output folder under
    tmp_path instead of the tool's fixed one) against the port's run_arm.
    The same line, the same keyframes, kf-ATE within 1e-3 relative."""
    import ate_matrix as j_ate
    from splatslam_tpu.slam import SLAM as JSLAM
    monkeypatch.chdir(REPO)
    cfg = j_ate.base_cfg()
    cfg["data"]["output"] = str(tmp_path / "jax" / "base")
    slam_j = JSLAM(cfg)
    ate = slam_j.run()
    rmse_j = ate.get("rmse") if isinstance(ate, dict) else ate
    want = f"ARM {'base':8s} kf_ate {rmse_j}  n_kf {slam_j.video.counter}"
    capsys.readouterr()
    rmse, n_kf = t_ate.run_arm("base", t_ate.ARMS["base"], device="cpu",
                               out=str(tmp_path / "t"))
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("ARM ")]
    print(want, *got, sep="\n")
    assert len(got) == 1
    assert re.sub(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", "#", got[0]) == \
        re.sub(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", "#", want)
    assert n_kf == slam_j.video.counter
    np.testing.assert_allclose(rmse, rmse_j, rtol=1e-3, atol=1e-3)
