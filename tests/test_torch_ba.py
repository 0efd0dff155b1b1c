"""Bundle adjustment of the PyTorch port against splatslam_tpu.ops.ba.

One stage-1 DBA (pose+depth and motion-only) and one stage-2
scale/shift iteration on a synthetic scene with GT-flow targets; poses
(as 4×4 matrices) and disparities must match to rtol 1e-3 — float32
normal equations whose Schur complement is summed in another order
(dense per-(frame, pose) coupling here, edge groups in the JAX code).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatslam_tpu.ops import ba as jba, lie as jlie, projective as jpops
from splatslam_tpu_torch.ops import ba as tba, lie as tlie
from test_torch_threads import few_torch_threads  # noqa: F401


def _scene(seed=0, P=5, H=8, W=12):
    """GT poses/disparities, GT-flow targets over |i−j| ≤ 2 edges, and a
    perturbed start — all host numpy, fed to both packages."""
    rng = np.random.RandomState(seed)
    xs = np.cumsum(rng.randn(P, 6) * np.array([0.08, 0.08, 0.15, 0.02, 0.02,
                                                0.02]), axis=0)
    poses_gt = np.asarray(jlie.exp(jnp.asarray(xs, jnp.float32)))
    disps_gt = (0.4 + 0.3 * rng.rand(P, H, W)).astype(np.float32)
    intr = np.asarray([12.0, 12.0, W / 2.0, H / 2.0], np.float32)
    pairs = [(i, j) for i in range(P) for j in range(P)
             if i != j and abs(i - j) <= 2]
    ii = np.asarray([p[0] for p in pairs], np.int32)
    jj = np.asarray([p[1] for p in pairs], np.int32)
    target, valid = jpops.projective_transform(
        jnp.asarray(poses_gt)[None], jnp.asarray(disps_gt)[None],
        jnp.broadcast_to(jnp.asarray(intr), (P, 4))[None],
        jnp.asarray(ii), jnp.asarray(jj))
    weight = np.asarray(jnp.ones_like(target) * valid)[0]
    dxi = (rng.randn(P, 6) * 0.02).astype(np.float32)
    dxi[0] = 0.0
    poses0 = np.asarray(jlie.retr(jnp.asarray(poses_gt), jnp.asarray(dxi)))
    disps0 = np.clip(disps_gt * (1.0 + 0.15 * rng.randn(P, H, W)), 0.05,
                     None).astype(np.float32)
    return dict(poses=poses0, disps=disps0, intr=intr, ii=ii, jj=jj,
                target=np.asarray(target[0]), weight=weight,
                disps_gt=disps_gt)


def _mats(poses):
    return np.asarray(jax.vmap(jlie.to_matrix)(jnp.asarray(poses)))


T = lambda x: torch.as_tensor(np.array(x))


@pytest.mark.parametrize("motion_only", [False, True],
                         ids=["pose_depth", "motion_only"])
def test_dba_iteration_matches_jax(motion_only):
    s = _scene()
    P, H, W = s["disps"].shape
    t0, t1 = 1, P
    plan = jba.make_edge_plan(s["ii"], s["jj"], t0, t1)
    edges = tba.make_edges(s["ii"], s["jj"], t0, t1)
    eta = np.full((plan.M, H, W), 1e-4, np.float32)
    pj, dj = jba.dba(jnp.asarray(s["poses"]), jnp.asarray(s["disps"]),
                     jnp.asarray(s["intr"]), jnp.asarray(s["target"]),
                     jnp.asarray(s["weight"]), jnp.asarray(eta),
                     jnp.zeros((P, H, W)), plan, iters=1, ep=0.01,
                     motion_only=motion_only)
    pt, dt = tba.dba(T(s["poses"]), T(s["disps"]), T(s["intr"]),
                     T(s["target"]), T(s["weight"]), T(eta[:edges.M]),
                     torch.zeros(P, H, W), edges, iters=1, ep=0.01,
                     motion_only=motion_only)
    moved = np.abs(_mats(pj) - _mats(s["poses"])).max()
    assert moved > 1e-3          # the step is not trivially zero
    np.testing.assert_allclose(tlie.to_matrix(pt).numpy(), _mats(pj),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-3,
                               atol=1e-5)


def test_scale_shift_iteration_matches_jax():
    s = _scene(seed=2)
    P, H, W = s["disps"].shape
    mono = ((s["disps_gt"] - 0.1) / 2.0).astype(np.float32)
    vmask = np.random.RandomState(3).rand(P, H, W) > 0.3
    scales = np.ones(P, np.float32)
    shifts = np.zeros(P, np.float32)
    plan = jba.make_edge_plan(s["ii"], s["jj"], 1, P)
    edges = tba.make_edges(s["ii"], s["jj"], 1, P)
    eta = np.full((plan.M, H, W), 1e-4, np.float32)
    gt_poses = np.asarray(s["poses"])
    want = jba.ba_scale_shift(
        jnp.asarray(gt_poses), jnp.asarray(s["disps"]),
        jnp.asarray(s["intr"]), jnp.asarray(s["target"]),
        jnp.asarray(s["weight"]), jnp.asarray(eta), jnp.asarray(mono),
        jnp.asarray(scales), jnp.asarray(shifts), jnp.asarray(vmask), plan,
        iters=1)
    got = tba.ba_scale_shift(
        T(gt_poses), T(s["disps"]), T(s["intr"]), T(s["target"]),
        T(s["weight"]), T(eta[:edges.M]), T(mono), T(scales), T(shifts),
        T(vmask), edges, iters=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-5)


def test_solve_damped_zero_on_failure():
    """An indefinite system (Cholesky fails) returns zeros, as
    _chol_solve_core does, instead of raising; so does a system whose
    weights are all zero except the damping."""
    A = np.diag([1.0, -5.0, 2.0]).astype(np.float32)
    b = np.ones((3, 1), np.float32)
    got = tba.solve_damped(T(A), T(b), 0.1, 1e-4)
    want = np.asarray(jba.solve_damped(jnp.asarray(A), jnp.asarray(b), 0.1,
                                       1e-4))
    np.testing.assert_array_equal(got.numpy(), 0.0)
    np.testing.assert_array_equal(want, 0.0)
    Z = np.zeros((6, 6), np.float32)
    got = tba.solve_damped(T(Z), T(np.ones((6, 1), np.float32)), 0.1, 1e-4)
    np.testing.assert_allclose(got.numpy(), 10.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_align_scale_and_shift_matches_jax(case):
    rng = np.random.RandomState(0)
    pred = (rng.rand(3, 6, 8) + 0.5).astype(np.float32)
    target = (2.5 * pred - 0.3 + 0.01 * rng.randn(3, 6, 8)).astype(np.float32)
    w = rng.rand(3, 6, 8) > 0.4
    if case == "degenerate":
        w[0] = False                 # empty mask
        w[1] = False                 # one pixel: det is exactly 0
        w[1, 2, 3] = True
    want = jba.align_scale_and_shift(jnp.asarray(pred), jnp.asarray(target),
                                     jnp.asarray(w))
    got = tba.align_scale_and_shift(T(pred), T(target), T(w))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-4,
                                   atol=1e-5)


def test_schur_and_block_solve_match_jax():
    rng = np.random.RandomState(1)
    B, P, M, D, HW = 1, 3, 2, 6, 5
    A = rng.randn(B, P * D, P * D).astype(np.float32)
    Hd = (A @ A.transpose(0, 2, 1) + 5 * np.eye(P * D)).astype(np.float32)
    H = Hd.reshape(B, P, D, P, D).transpose(0, 1, 3, 2, 4)
    E = (0.1 * rng.randn(B, P, M, D, HW)).astype(np.float32)
    C = (1.0 + rng.rand(B, M, HW)).astype(np.float32)
    v = rng.randn(B, P, D).astype(np.float32)
    w = rng.randn(B, M, HW).astype(np.float32)
    want = jba.schur_solve(*[jnp.asarray(x) for x in (H, E, C, v, w)])
    got = tba.schur_solve(*[T(x) for x in (H, E, C, v, w)])
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tba.block_solve(T(H), T(v)).numpy(),
        np.asarray(jba.block_solve(jnp.asarray(H), jnp.asarray(v))),
        rtol=1e-4, atol=1e-5)
