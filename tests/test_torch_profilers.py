"""The port's three profilers (splatslam_tpu_torch/tools/tracking_profile,
map_step_profile, kernel_bench) against the JAX repository's tools
(tools/tracking_profile.py, map_step_profile.py, kernel_bench.py).

The JAX tools hard-code their work inside main(), so the JAX side is
composed from the JAX package's functions, the calls each JAX row makes,
on the port tool's own inputs carried across as numpy (weights through
convert.droid_params_to_numpy, the map field by field): every row of each
tool is built at a shrunk size on the CPU, called once, and its output is
held against the JAX call's at the tolerance of that module's existing
parity test: the network atol 2e-4 / rtol 1e-3 (test_torch_droid_net.py),
the correlation lookup the same (test_torch_corr.py), DBA rtol 1e-3 / atol
1e-5 (test_torch_ba.py; kernel_bench's random-target DBA is refereed by a
float64 solve, see there), frame_distance rtol 1e-5 and depth_filter exact
(test_torch_tracking.py), upsampling atol 1e-5 (tests/test_droid_net.py),
B1/B2 against the Pallas kernels in interpret mode atol 1e-5 / n_touched
exact / 2e-4 (test_torch_rasterizer.py), rendering atol 1e-4 and its
gradients atol 1e-4 / rtol 1e-3 (the same file), a map_step rtol 1e-3 /
atol 1e-5 with the loss rtol 1e-5, a map_step_n segment rtol 1e-3
(test_torch_mapping.py; the segment shrunk to that test's 4 iterations).
The projection, which no other file holds on its own, is held at the
rendering's atol 1e-4 with the radii exact.

Both networks run in float32 (SPLATSLAM_F32_NET, set for the module) at
sizes no other file traces (56x88, 40x72): the JAX package reads the
variable when it traces. The CLIs themselves run once each on the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu_torch import convert
from splatslam_tpu_torch.mapping.gaussians import FIELDS
from splatslam_tpu_torch.ops import lie as tlie
from splatslam_tpu_torch.tools import _profile
from splatslam_tpu_torch.tools import kernel_bench as t_kb
from splatslam_tpu_torch.tools import map_step_profile as t_ms
from splatslam_tpu_torch.tools import tracking_profile as t_tp
from test_torch_threads import few_torch_threads  # noqa: F401

NET = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def f32_net():
    old = os.environ.get("SPLATSLAM_F32_NET")
    os.environ["SPLATSLAM_F32_NET"] = "1"
    yield
    if old is None:
        os.environ.pop("SPLATSLAM_F32_NET", None)
    else:
        os.environ["SPLATSLAM_F32_NET"] = old


def _n(x):
    return x.detach().float().cpu().numpy()


def _nhwc(x):
    """(B,C,h,w) tensor → (B,h,w,C) numpy."""
    return np.moveaxis(_n(x), 1, -1)


def _params(model):
    return jax.tree_util.tree_map(jnp.asarray,
                                  convert.droid_params_to_numpy(model))


def _outputs(rows):
    """Every row called once (after its reset), by name."""
    out = {}
    for r in rows:
        if r.reset:
            r.reset()
        out[r.name] = r.fn()
    return out


def _jax_state(st):
    """The port's GaussianState as the JAX package's."""
    from splatslam_tpu.mapping import gaussians as jG
    return dataclasses.replace(jG.make_state(st.capacity), **{
        k: jnp.asarray(getattr(st, k).numpy()) for k in FIELDS})


def _assert_state(st_t, st_j, steps, fields=None):
    """Fields at test_torch_mapping.py's rtol 1e-3 / atol 1e-5, except the
    rotations: the profilers' splats are isotropic, so a rotation's
    gradient is zero up to rounding and Adam's steps turn that noise into
    ±lr of either sign (rendering does not see it); they are held to 2·lr
    per Adam step."""
    for f in dataclasses.fields(st_j):
        if fields is not None and f.name not in fields:
            continue
        got = _n(getattr(st_t, f.name))
        want = np.asarray(getattr(st_j, f.name), np.float32)
        if f.name == "rotation":
            assert np.abs(got - want).max() <= \
                2 * t_ms.LRS[f.name] * steps + 1e-6, f.name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                                       err_msg=f.name)


def test_tracking_profile_rows_match_jax():
    from splatslam_tpu.models.droid_net import DroidNet, normalize_images
    from splatslam_tpu.ops import ba as jba, corr as jcorr, lie as jlie
    from splatslam_tpu.ops.upsample import upsample_disp
    args = t_tp.build_parser().parse_args(
        ["--edges", "6", "--hw", "56,88", "--frames", "5"])
    s = t_tp.setup(args, "cpu")
    rows = t_tp.rows(s)
    assert [r.name for r in rows] == [
        "fnet_ms", "cnet_ms", "alt_corr_ms", "update_step_ms",
        "update_agg_ms", "dba_2iter_ms", "upsample_ms"]
    got = _outputs(rows)
    params = _params(s.model)
    net = DroidNet(dtype=jnp.float32)
    ap = lambda method, *a: net.apply({"params": params}, *a, method=method)
    img = jnp.asarray(_n(s.img))
    np.testing.assert_allclose(_nhwc(got["fnet_ms"]),
                               ap(DroidNet.features, normalize_images(img)),
                               **NET)
    for g, w in zip(got["cnet_ms"],
                    ap(DroidNet.context, normalize_images(img))):
        np.testing.assert_allclose(_nhwc(g), w, **NET)
    pyr = jcorr.build_fmap_pyramid(jnp.asarray(_nhwc(s.fmaps)), 4)
    ii, jj = jnp.asarray(s.ii.numpy()), jnp.asarray(s.jj.numpy())
    coords = jnp.asarray(_n(s.coords))
    corr = jcorr.alt_corr(pyr, ii, jj, coords)
    np.testing.assert_allclose(_nhwc(got["alt_corr_ms"]), corr, **NET)
    z = jnp.zeros((s.N, s.h, s.w, 128))
    for g, w in zip(got["update_step_ms"],
                    ap(DroidNet.update_step, z, z, corr,
                       jnp.zeros((s.N, s.h, s.w, 4)))):
        np.testing.assert_allclose(_nhwc(g), w, **NET)
    for g, w, name in zip(got["update_agg_ms"],
                          ap(DroidNet.update_agg, z,
                             jnp.asarray(s.ix.numpy()), s.n_uniq),
                          ("eta", "upmask")):
        g = _n(g) if name == "eta" else _nhwc(g)
        np.testing.assert_allclose(g, w, **NET, err_msg=name)
    plan = jba.make_edge_plan(s.ii.numpy(), s.jj.numpy(), t0=1, t1=s.M)
    pj, dj = jba.dba(jnp.asarray(_n(s.poses)), jnp.asarray(_n(s.disps)),
                     jnp.asarray(_n(s.intr8)), coords,
                     jnp.ones((s.N, s.h, s.w, 2)),
                     jnp.full((plan.M, s.h, s.w), 1e-3),
                     jnp.zeros((s.M, s.h, s.w)), plan, iters=2)
    pt, dt = got["dba_2iter_ms"]
    np.testing.assert_allclose(_n(tlie.to_matrix(pt)),
                               np.asarray(jlie.to_matrix(pj)), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(_n(dt), dj, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(
        _n(got["upsample_ms"]),
        upsample_disp(jnp.ones((4, s.h, s.w)),
                      jnp.zeros((4, s.h, s.w, 576))), atol=1e-5)


def test_map_step_profile_rows_match_jax():
    from splatslam_tpu.mapping import mapper as jM
    from splatslam_tpu.ops import raster_pallas as jrp, rasterizer as jrz
    args = t_ms.build_parser().parse_args(
        ["--gaussians", "512", "--cams", "2", "--hw", "48,64", "--K", "32"])
    s = t_ms.setup(args, "cpu", nit=4)
    rows = t_ms.rows(s)
    assert [r.name for r in rows] == [
        "project_ms", "bin_ms", "packets_ms", "composite_fwd_ms",
        "composite_fwd_notouch_ms", "composite_bwd_ms", "rast_fwd_ms",
        "rast_vjp_ms", "map_step_ms", "map_step_hot_ms",
        "map_step_n_periter_ms"]
    got = _outputs(rows)
    B, H, W, K, C = s.B, s.H, s.W, s.K, s.C
    st = s.st
    J = lambda x: jnp.asarray(_n(x) if x.is_floating_point() else x.numpy())
    xyz, scal, rot, opac, cols, alive = (J(x) for x in (
        st.xyz, s.scal, st.rotation, s.opac, s.cols, st.alive))
    w2cs, intr = J(s.w2cs), J(s.intr)

    proj = jax.vmap(jrz.project_gaussians,
                    in_axes=(None, None, None, 0, None, None, None))(
        xyz, scal, rot, w2cs, intr, H, W)
    for name, g, w in zip(("means2d", "depth", "conic", "radius",
                           "in_front"), got["project_ms"], proj):
        if name in ("radius", "in_front"):
            np.testing.assert_array_equal(_n(g), np.asarray(w), name)
        else:
            np.testing.assert_allclose(_n(g), w, atol=1e-4, rtol=1e-4,
                                       err_msg=name)
    ids_j, cnt_j = jrz.bin_gaussians_batch(
        J(s.means2d), J(s.radius), J(s.depth_z), J(s.visible), s.ntx, s.nty,
        K)
    np.testing.assert_array_equal(got["bin_ms"][1].numpy(), cnt_j)
    np.testing.assert_array_equal(got["bin_ms"][0].numpy(), ids_j)
    pk_j = jnp.concatenate([
        J(s.means2d), J(s.conic), jnp.broadcast_to(cols[None], (B, C, 3)),
        jnp.broadcast_to(opac[None, :, None], (B, C, 1)),
        J(s.depth_z)[..., None]], -1)
    np.testing.assert_array_equal(_n(got["packets_ms"]), pk_j)

    T = s.ntx * s.nty
    tl_T, ids_smem, counts_flat = jrz._pallas_prep(
        J(s.tile_ids), J(s.tile_counts), J(s.packets))
    for name, touch in (("composite_fwd_ms", True),
                        ("composite_fwd_notouch_ms", False)):
        out_j, nt_j = jrp.composite_fwd_pallas(
            counts_flat, tl_T, ids_smem, B, T, s.ntx, C, want_touched=touch,
            interpret=True)
        out_t, nt_t = got[name]
        np.testing.assert_allclose(_n(out_t).reshape(B * T, 5, 256),
                                   np.asarray(out_j)[:, :5], atol=1e-5)
        if touch:
            np.testing.assert_array_equal(
                nt_t.numpy(), np.asarray(nt_j[:, :, 0, :]).reshape(B, C))
        else:
            assert not nt_t.any()
    assert got["composite_fwd_ms"][1].sum() > 0
    gpack = jnp.concatenate([jnp.full((B * T, 5, 256), 1e-3),
                             jnp.zeros((B * T, 3, 256))], 1)
    out_j, _ = jrp.composite_fwd_pallas(counts_flat, tl_T, ids_smem, B, T,
                                        s.ntx, C, interpret=True)
    acc = jrp.composite_bwd_pallas(counts_flat, tl_T, ids_smem, gpack, out_j,
                                   B, T, s.ntx, C, interpret=True)
    g_j = np.asarray(acc.transpose(0, 2, 1, 3).reshape(B, 16, C)[:, :10]
                     ).transpose(0, 2, 1)
    np.testing.assert_allclose(_n(got["composite_bwd_ms"]), g_j, rtol=2e-4,
                               atol=2e-4)

    rast = lambda *d: jrz.rasterize_batch(
        *d, alive, w2cs, jnp.zeros((B, 6)), intr, jnp.zeros(3), H=H, W=W,
        K=K)
    out_j = rast(xyz, scal, rot, opac, cols)
    out_t = got["rast_fwd_ms"]
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(_n(getattr(out_t, name)),
                                   getattr(out_j, name), atol=1e-4)
    np.testing.assert_array_equal(out_t.n_touched.numpy(), out_j.n_touched)
    g_j = jax.grad(lambda *d: rast(*d).color.sum() + rast(*d).depth.sum(),
                   argnums=(0, 1, 2, 3, 4))(xyz, scal, rot, opac, cols)
    for g, w in zip(got["rast_vjp_ms"], g_j):
        assert np.abs(np.asarray(w)).max() > 0
        np.testing.assert_allclose(_n(g), w, atol=1e-4, rtol=1e-3)

    st_j = _jax_state(st)
    z2, z6 = jnp.zeros((B, 2)), jnp.zeros((B, 6))
    ones = jnp.ones(B, bool)
    cams = (w2cs, J(s.imgs), J(s.deps), z2, ones, ones, ~ones, intr,
            t_ms.LRS, tuple(jnp.asarray(x) for x in t_ms.CAM_LRS))
    kw = dict(H=H, W=W, K=K, use_ssim=False, alpha=0.8)
    want = {
        "map_step_ms": jM.map_step(st_j, (z2, z2), (z6, z6), *cams,
                                   jnp.asarray(1), jnp.asarray(10.0), **kw),
        "map_step_hot_ms": jM.map_step(
            st_j, (z2, z2), (z6, z6), *cams, jnp.asarray(1),
            jnp.asarray(10.0), J(s.tile_ids), J(s.tile_counts),
            want_touched=False, **kw),
    }
    for name, w in want.items():
        g = got[name]
        np.testing.assert_allclose(float(g[-1]), float(w[-1]), rtol=1e-5)
        _assert_state(g[0], w[0], steps=1)
        np.testing.assert_array_equal(g[6].numpy(), np.asarray(w[6]))
    w = jM.map_step_n(st_j, (z2, z2), (z6, z6), *cams, jnp.asarray(0),
                      jnp.asarray(s.nit), jnp.asarray(10.0), **kw)
    g = got["map_step_n_periter_ms"]
    np.testing.assert_allclose(float(g[-1]), float(w[-1]), rtol=1e-3)
    _assert_state(g[0], w[0], steps=s.nit, fields=(
        "xyz", "f_dc", "opacity", "scaling", "rotation", "alive",
        "grad_accum", "denom", "max_radii2D"))
    # every map_step row started from the profiler's map, which is intact
    np.testing.assert_array_equal(_n(s.st.opacity),
                                  np.zeros((C, 1), np.float32))


def test_kernel_bench_rows_match_jax():
    from splatslam_tpu.models.droid_net import DroidNet
    from splatslam_tpu.mapping import mapper as jM
    from splatslam_tpu.ops import ba as jba, lie as jlie, rasterizer as jrz
    from splatslam_tpu.tracking import depth_video as jdv
    from splatslam_tpu.tracking.factor_graph import _update_kernel
    from splatslam_tpu_torch.ops import ba as tba
    args = t_kb.build_parser().parse_args(["--gaussians", "512"])
    s = t_kb.setup(args, "cpu", H=40, W=72, P=12, N=8, window=10,
                   n_filter=6, B=2)
    rows = t_kb.rows(s)
    assert [r.name for r in rows] == [
        "fnet_40x72_ms", "cnet_40x72_ms", "update_operator_8edges_ms",
        "dba_8edges_2iter_ms", "frame_distance_8_ms", "depth_filter_6_ms",
        "rasterize_fwd_256g_ms", "map_step_2cam_256g_ms"]
    got = _outputs(rows)
    params = _params(s.model32)
    net = DroidNet()
    ap = lambda method, *a: net.apply({"params": params}, *a, method=method)
    img = jnp.asarray(np.moveaxis(_n(s.img), 1, -1))
    np.testing.assert_allclose(_nhwc(got["fnet_40x72_ms"]),
                               ap(DroidNet.features, img), **NET)
    for g, w in zip(got["cnet_40x72_ms"], ap(DroidNet.context, img)):
        np.testing.assert_allclose(_nhwc(g), w, **NET)

    J = lambda x: jnp.asarray(_n(x))
    poses, disps, intr8 = J(s.poses), J(s.disps), J(s.intr8)
    ii_np, jj_np = s.ii.numpy(), s.jj.numpy()
    ii, jj = jnp.asarray(ii_np, jnp.int32), jnp.asarray(jj_np, jnp.int32)
    uniq, ix = np.unique(ii_np, return_inverse=True)
    Mk = ((len(uniq) + 7) // 8) * 8
    net_j, tgt_j, wgt_j, eta_j, up_j, _, _ = _update_kernel(
        params, poses, disps, intr8,
        jnp.asarray(_nhwc(s.fmaps), jnp.bfloat16), jnp.asarray(_nhwc(s.inps)),
        jnp.zeros((s.N, s.h, s.w, 128)), jnp.zeros((s.N, s.h, s.w, 2)), ii,
        jj, jnp.ones(s.N, bool), jnp.asarray(ix, jnp.int32), Mk)
    net_t, tgt_t, wgt_t, eta_t, up_t, uniq_t, _ = \
        got["update_operator_8edges_ms"]
    np.testing.assert_array_equal(uniq_t.numpy(), uniq)
    M = len(uniq)
    for name, g, w in (("net", _nhwc(net_t), net_j),
                       ("target", _n(tgt_t), tgt_j),
                       ("weight", _n(wgt_t), wgt_j),
                       ("eta", _n(eta_t), np.asarray(eta_j)[:M]),
                       ("upmask", _nhwc(up_t), np.asarray(up_j)[:M])):
        np.testing.assert_allclose(g, w, **NET, err_msg=name)

    # The tool's DBA targets are random, unrelated to the geometry (a
    # timing input): two steps drive disparities to the 1e-5 clamp and the
    # float32 solve is ill-conditioned — the JAX call's own float32 result
    # is 2.1e-4 (pose matrices) and 1.6e-3 (disparities) from a float64
    # solve of the same system. So both float32 results are held to the
    # port's float64 solve (the same function, refereed), at 5e-4 / 5e-3.
    plan = jba.make_edge_plan(ii_np, jj_np, 1, s.window)
    pj, dj = jba.dba(poses, disps, intr8, J(s.target_r), J(s.weight),
                     jnp.full((plan.M, s.h, s.w), 1e-4),
                     jnp.zeros_like(disps), plan, iters=2)
    d = lambda x: x.double()
    p64, d64 = tba.dba(d(s.poses), d(s.disps), d(s.intr8), d(s.target_r),
                       d(s.weight), d(s.eta), torch.zeros_like(d(s.disps)),
                       s.edges, iters=2)
    m64, d64 = tlie.to_matrix(p64).numpy(), d64.numpy()
    pt, dt = got["dba_8edges_2iter_ms"]
    for p32, d32 in ((_n(tlie.to_matrix(pt)), _n(dt)),
                     (np.asarray(jlie.to_matrix(pj)), np.asarray(dj))):
        np.testing.assert_allclose(p32, m64, atol=5e-4, rtol=0)
        np.testing.assert_allclose(d32, d64, atol=5e-3, rtol=0)
    np.testing.assert_allclose(
        _n(got["frame_distance_8_ms"]),
        jdv.frame_distance_kernel(poses, disps, intr8, ii, jj, 0.6),
        rtol=1e-5)
    np.testing.assert_array_equal(
        _n(got["depth_filter_6_ms"]),
        jdv.depth_filter_kernel(poses, disps, intr8,
                                jnp.arange(s.n_filter, dtype=jnp.int32),
                                jnp.full((s.n_filter,), 0.01)))

    from splatslam_tpu.mapping import gaussians as jG
    st_j = _jax_state(s.st)
    intr = J(s.intr)
    out_j = jrz.rasterize(
        st_j.xyz, jG.get_scaling(st_j), st_j.rotation,
        jG.get_opacity(st_j)[:, 0], jG.get_colors_dc(st_j), st_j.alive,
        jnp.eye(4), jnp.zeros(6), intr, jnp.zeros(3), H=s.H, W=s.W, K=256)
    out_t = got["rasterize_fwd_256g_ms"]
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(_n(getattr(out_t, name)),
                                   getattr(out_j, name), atol=1e-4)
    np.testing.assert_array_equal(out_t.n_touched.numpy(), out_j.n_touched)
    B = s.B
    z2, z6 = jnp.zeros((B, 2)), jnp.zeros((B, 6))
    ones = jnp.ones(B, bool)
    w = jM.map_step(st_j, (z2, z2), (z6, z6), J(s.w2cs), J(s.imgs),
                    J(s.deps), z2, ones, ones, ~ones, intr, t_ms.LRS,
                    tuple(jnp.asarray(x) for x in t_ms.CAM_LRS),
                    jnp.asarray(1), jnp.asarray(10.0), H=s.H, W=s.W, K=256,
                    use_ssim=False, alpha=0.8)
    g = got["map_step_2cam_256g_ms"]
    np.testing.assert_allclose(float(g[-1]), float(w[-1]), rtol=1e-5)
    _assert_state(g[0], w[0], steps=1)


def test_timing_and_output(capsys):
    """A row is timed over its n calls (reset before each, outside the
    timing) and reported per iteration; the CLIs print one JSON line of
    finite, positive rows with the JAX tools' extras."""
    calls = []
    row = _profile.Row("x_ms", lambda: calls.append("fn"), n=3, per=4,
                       reset=lambda: calls.append("reset"))
    assert _profile.time_row(row, "cpu") > 0
    assert calls == ["reset", "fn"] * 5
    for mod, argv, n_rows, extras in (
            (t_tp, ["--edges", "8", "--hw", "56,88", "--frames", "6"], 7,
             dict(edges=8, h=7, w=11, frames=6)),
            (t_ms, ["--gaussians", "256", "--cams", "1", "--hw", "32,48",
                    "--K", "16", "--ssim", "--dense", "--opt-poses"], 11,
             dict(B=1, H=32, W=48, K=16, capacity=256, alive=128, ssim=True,
                  opt_poses=True, dense=True))):
        out = mod.main(argv + ["--json", "--device", "cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line == json.loads(json.dumps(out))
        rows = {k: v for k, v in line.items() if k.endswith("_ms")}
        assert len(rows) == n_rows
        assert all(np.isfinite(v) and v > 0 for v in rows.values())
        assert {k: line[k] for k in extras} == extras
        assert line["device"] == "cpu"


def test_profilers_need_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (t_tp, t_ms, t_kb):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--json"])
