"""Dense bundle adjustment (DBA) and the DSPO layer in PyTorch (counterpart
of splatslam_tpu/ops/ba.py).

  * stage-1 "pose_depth" DBA: Gauss-Newton over keyframe poses and 1/8-res
    disparities, depth eliminated by a Schur complement;
  * stage-2 "depth_scale" BA: disparities plus a per-frame mono-prior
    scale/shift, poses frozen — M independent 2×2 Schur systems (on the
    card one kernel launch an iteration, csrc/dspo.cu);
  * the damped Cholesky solve that returns zeros when it fails.

Edge sets are exact-size (`EdgeSet`): the JAX package pads them into shape
buckets only to avoid XLA recompiles, which eager PyTorch does not need.
The pose/depth coupling E is held dense per (depth frame, pose slot)
(M, P, 6, h·w), so S = E Q Eᵀ is one batched matmul.

`dba` also takes a leading scene dimension: S problems on one edge set,
solved side by side, each with its own gauge and its own fallback (the
self-trainer's counterpart of `jax.vmap` over the scenes of a batch).
"""

from __future__ import annotations

import dataclasses

import torch

from . import dspo_cuda
from . import lie
from . import projective as pops
from ..utils.profiling import tally


@dataclasses.dataclass
class EdgeSet:
    """One BA problem's edges and the frames they touch.

    ii/jj (E,) source/target keyframes; poses [t0, t1) are optimised;
    kx (M,) the depth frames unique(arange(t0, t1) ∪ ii); kk (E,) the row
    of each edge's ii in kx."""
    ii: torch.Tensor
    jj: torch.Tensor
    kx: torch.Tensor
    kk: torch.Tensor
    t0: int
    t1: int
    _by_frame: tuple | None = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def P(self):
        return self.t1 - self.t0

    @property
    def M(self):
        return self.kx.shape[0]

    def by_frame(self):
        """(order (E,), offsets (M+1,)): the edges sorted by kk, stably
        (each depth frame's edges keep their order), and where each
        frame's run starts in that order. Made on the edges' device
        without a host sync, once per edge set."""
        if self._by_frame is None:
            kk_sorted, order = torch.sort(self.kk, stable=True)
            self._by_frame = (order, torch.searchsorted(
                kk_sorted, torch.arange(self.M + 1, device=self.kk.device)))
        return self._by_frame


def make_edges(ii, jj, t0: int, t1: int, device=None) -> EdgeSet:
    ii = torch.as_tensor(ii, dtype=torch.long, device=device).reshape(-1)
    jj = torch.as_tensor(jj, dtype=torch.long, device=device).reshape(-1)
    kx = torch.unique(torch.cat([torch.arange(t0, t1, device=ii.device), ii]))
    kk = torch.searchsorted(kx, ii)
    return EdgeSet(ii=ii, jj=jj, kx=kx, kk=kk, t0=int(t0), t1=int(t1))


# ---------------------------------------------------------------------------
# damped Cholesky with graceful failure
# ---------------------------------------------------------------------------

def _damp(A, ep: float, lm: float):
    """diag(A) ← diag(A)·(1+lm) + ep."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    return A + torch.diag_embed(ep + lm * diag)


def _chol_solve_core(A, b, lead: int = 0):
    """Cholesky solve; zeros (not an exception) when the factorisation
    fails or the solution is not finite. cholesky_ex reports failure in
    `info` without a host sync. The first `lead` batch dimensions are
    independent problems that fall back one by one (a vmapped solve); the
    others fall back together, as the JAX package's batched solve does."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b, L)
    fail = (info != 0) | ~torch.isfinite(x).all(-1).all(-1)
    ok = ~fail.reshape(*fail.shape[:lead], -1).any(-1)
    return torch.where(ok[(...,) + (None,) * (x.dim() - lead)], x,
                       torch.zeros_like(x))


def solve_damped(A, b, ep: float, lm: float, lead: int = 0):
    """Damped PSD solve; returns zeros instead of failing (per problem of
    the first `lead` dimensions, see _chol_solve_core)."""
    return _chol_solve_core(_damp(A, ep, lm), b, lead)


def block_solve(H, v, ep: float = 0.1, lm: float = 1e-4):
    """H (B, N, N, D, D), v (B, N, D) → (B, N, D)."""
    B, N, _, D, _ = H.shape
    Hd = H.permute(0, 1, 3, 2, 4).reshape(B, N * D, N * D)
    x = solve_damped(Hd, v.reshape(B, N * D, 1), ep, lm)
    return x.reshape(B, N, D)


def schur_solve(H, E, C, v, w, ep: float = 0.1, lm: float = 1e-4):
    """Dense Schur-complement solve. H (B,P,P,D,D), E (B,P,M,D,HW),
    C/w (B,M,HW), v (B,P,D) → (dx (B,P,D), dz (B,M,HW))."""
    B, P, M, D, HW = E.shape
    Hd = _damp(H.permute(0, 1, 3, 2, 4).reshape(B, P * D, P * D), ep, lm)
    Ed = E.permute(0, 1, 3, 2, 4).reshape(B, P * D, M * HW)
    Q = (1.0 / C).reshape(B, M * HW, 1)
    Et = Ed.transpose(1, 2)
    S = Hd - Ed @ (Q * Et)
    rhs = v.reshape(B, P * D, 1) - Ed @ (Q * w.reshape(B, M * HW, 1))
    dx = _chol_solve_core(S, rhs)
    dz = Q * (w.reshape(B, M * HW, 1) - Et @ dx)
    return dx.reshape(B, P, D), dz.reshape(B, M, HW)


# ---------------------------------------------------------------------------
# stage-1 DBA
# ---------------------------------------------------------------------------

def _edge_terms(poses, disps, intrinsics, target, weight, ii, jj):
    """Per-edge reductions: (Hii, Hij, Hji, Hjj) (E,6,6), (vi, vj) (E,6),
    (Ei, Ej) (E,6,HW), Ck (E,HW), wk (E,HW)."""
    E = ii.shape[0]
    HW = disps.shape[-2] * disps.shape[-1]
    intr = intrinsics.expand(poses.shape[0], 4)
    coords, valid, (Ji, Jj, Jz) = pops.projective_transform(
        poses[None], disps[None], intr[None], ii, jj, jacobian=True)
    r = (target - coords[0]).reshape(E, HW, 2)
    w = (0.001 * valid[0] * weight).reshape(E, HW, 2)
    Ji = Ji[0].reshape(E, HW, 2, 6)
    Jj = Jj[0].reshape(E, HW, 2, 6)
    Jz = Jz[0].reshape(E, HW, 2)
    wJi = w[..., None] * Ji
    wJj = w[..., None] * Jj
    Hii = torch.einsum("nhca,nhcb->nab", wJi, Ji)
    Hij = torch.einsum("nhca,nhcb->nab", wJi, Jj)
    Hji = torch.einsum("nhca,nhcb->nab", wJj, Ji)
    Hjj = torch.einsum("nhca,nhcb->nab", wJj, Jj)
    vi = torch.einsum("nhca,nhc->na", wJi, r)
    vj = torch.einsum("nhca,nhc->na", wJj, r)
    Ei = torch.einsum("nhca,nhc->nah", wJi, Jz)
    Ej = torch.einsum("nhca,nhc->nah", wJj, Jz)
    wk = (w * r * Jz).sum(-1)
    Ck = (w * Jz * Jz).sum(-1)
    return (Hii, Hij, Hji, Hjj), (vi, vj), (Ei, Ej), Ck, wk


def _pose_system(Hb, vb, pi, pj, P):
    """Dense (..., 6P, 6P) pose Hessian and (..., 6P) rhs from per-edge
    blocks (..., E, 6, 6) / (..., E, 6); blocks touching a pose outside
    [t0, t1) are dropped."""
    Hii, Hij, Hji, Hjj = Hb
    vi, vj = vb
    lead = Hii.shape[:-3]
    inr = lambda a: (a >= 0) & (a < P)
    Hf = Hii.new_zeros(*lead, P * P + 1, 6, 6)
    for a, b, blk in ((pi, pi, Hii), (pi, pj, Hij), (pj, pi, Hji),
                      (pj, pj, Hjj)):
        idx = torch.where(inr(a) & inr(b), a * P + b, P * P)
        Hf.index_add_(-3, idx, blk)
    H = Hf[..., :-1, :, :].reshape(*lead, P, P, 6, 6).transpose(-3, -2) \
        .reshape(*lead, 6 * P, 6 * P)
    vf = vi.new_zeros(*lead, P + 1, 6)
    for a, blk in ((pi, vi), (pj, vj)):
        vf.index_add_(-2, torch.where(inr(a), a, P), blk)
    return H, vf[..., :-1, :].reshape(*lead, 6 * P)


def _dba_iteration(poses, disps, intrinsics, target, weight, eta,
                   sensor_disps, edges: EdgeSet, lm, ep, motion_only,
                   alpha: float = 0.05):
    """One Gauss-Newton iteration of stage-1 DBA: returns (dx (..., P, 6),
    dz (..., M, HW) or None); `...` is dba's scene dimension, if any."""
    P, M = edges.P, edges.M
    lead = poses.shape[:-2]
    HW = disps.shape[-2] * disps.shape[-1]
    if lead:
        # the scenes' edges as one edge set over their S·N frames (each
        # scene's frames offset by s·N), each frame with its scene's
        # intrinsics; the blocks come back with the scene dimension
        S, N = poses.shape[:2]
        off = torch.arange(S, device=poses.device)[:, None] * N
        flat = lambda t: t.reshape(-1, *t.shape[2:])
        terms = _edge_terms(flat(poses), flat(disps),
                            intrinsics.repeat_interleave(N, 0), flat(target),
                            flat(weight), flat(edges.ii + off),
                            flat(edges.jj + off))
        unflat = lambda t: t.reshape(S, -1, *t.shape[1:])
        Hb, vb, (Ei, Ej), Ck, wk = (tuple(map(unflat, terms[0])),
                                    tuple(map(unflat, terms[1])),
                                    tuple(map(unflat, terms[2])),
                                    unflat(terms[3]), unflat(terms[4]))
    else:
        Hb, vb, (Ei, Ej), Ck, wk = _edge_terms(
            poses, disps, intrinsics, target, weight, edges.ii, edges.jj)
    pi = edges.ii - edges.t0
    pj = edges.jj - edges.t0
    H, v = _pose_system(Hb, vb, pi, pj, P)
    if motion_only:
        dx = solve_damped(H, v[..., None], ep, lm, len(lead))[..., 0]
        return dx.reshape(*lead, P, 6), None

    C = Ck.new_zeros(*lead, M, HW).index_add_(-2, edges.kk, Ck)
    w = wk.new_zeros(*lead, M, HW).index_add_(-2, edges.kk, wk)
    sens = sensor_disps[..., edges.kx, :, :].reshape(*lead, M, HW)
    msk = (sens > 0).to(C.dtype)
    disps_k = disps[..., edges.kx, :, :].reshape(*lead, M, HW)
    C = C + msk * alpha + (1.0 - msk) * eta.reshape(*lead, M, HW)
    w = w - msk * alpha * (disps_k - sens)
    Q = torch.where(C != 0, 1.0 / torch.where(C != 0, C, torch.ones_like(C)),
                    torch.zeros_like(C))

    # E[k, p] = Σ Ei over edges with (kk, pi) = (k, p) + Σ Ej over (kk, pj)
    Ed = Ei.new_zeros(*lead, M * P + 1, 6, HW)
    for p, blk in ((pi, Ei), (pj, Ej)):
        ok = (p >= 0) & (p < P)
        Ed.index_add_(-3, torch.where(ok, edges.kk * P + p, M * P), blk)
    Ed = Ed[..., :-1, :, :].reshape(*lead, M, P * 6, HW)
    EQ = Ed * Q[..., None, :]
    S = torch.matmul(EQ, Ed.transpose(-1, -2)).sum(-3)         # (6P, 6P)
    EQw = torch.matmul(EQ, w[..., None])[..., 0].sum(-2)       # (6P,)
    dx = solve_damped(H - S, (v - EQw)[..., None], ep, lm,
                      len(lead))[..., 0]
    Etdx = torch.matmul(dx[..., None, None, :].expand(*lead, M, 1, 6 * P),
                        Ed)[..., 0, :]
    dz = Q * (w - Etdx)
    return dx.reshape(*lead, P, 6), dz


def dba(poses, disps, intrinsics, target, weight, eta, sensor_disps,
        edges: EdgeSet, iters: int = 2, lm: float = 1e-4, ep: float = 0.1,
        motion_only: bool = False):
    """Stage-1 DBA / motion-only BA: `iters` Gauss-Newton steps.

    poses (B,7) SE3 w2c; disps (B,h,w); intrinsics (4,) at 1/8 res;
    target/weight (E,h,w,2); eta (M,h,w) per depth frame of edges.kx;
    sensor_disps (B,h,w) (zeros disable the prior). Returns new (poses,
    disps): poses[t0:t1] ← exp(dx) ∘ poses, disps[kx] ← max(disps + dz,
    1e-5).

    With a leading scene dimension S on every tensor (poses (S,B,7),
    intrinsics (S,4), ...) it solves S problems on `edges` side by side:
    each scene keeps its own gauge (its poses outside [t0, t1) fixed) and
    falls back to a zero step on its own, as `jax.vmap` of this function
    would.

    The updates are out of place (cat, index_copy), so the solver can be
    differentiated through, checkpointed or not (the self-trainer)."""
    h, w = disps.shape[-2:]
    t0, t1 = edges.t0, edges.t1
    lead = poses.shape[:-2]
    for _ in range(iters):
        dx, dz = _dba_iteration(poses, disps, intrinsics, target, weight,
                                eta, sensor_disps, edges, lm, ep,
                                motion_only)
        poses = torch.cat([poses[..., :t0, :],
                           lie.normalize(lie.retr(poses[..., t0:t1, :], dx)),
                           poses[..., t1:, :]], -2)
        if dz is not None:
            disps = disps.index_copy(-3, edges.kx, torch.clamp(
                disps[..., edges.kx, :, :] + dz.reshape(*lead, -1, h, w),
                min=1e-5))
    return poses, disps


# ---------------------------------------------------------------------------
# stage-2 DSPO: joint disparity / scale / shift, per-frame 2×2 Schur
# ---------------------------------------------------------------------------

def bad_mono_from_fit(sc, err, disps, valid_small, mono_thres):
    """Frames whose mono prior fits badly: relative error > mono_thres,
    negative scale, non-finite error, or < 50% multiview-valid pixels."""
    avg = disps.mean(dim=(-2, -1))
    vfrac = valid_small.to(disps.dtype).mean(dim=(-2, -1))
    return ((err / torch.clamp(avg, min=1e-8) > mono_thres)
            | ~torch.isfinite(err) | (sc < 0) | (vfrac < 0.5))


def bad_mono_frames(mono_disps, disps, valid_small, mono_thres):
    sc, _, err = align_scale_and_shift(mono_disps, disps, valid_small)
    return bad_mono_from_fit(sc, err, disps, valid_small, mono_thres)


def _scale_shift_iteration(poses, disps, intrinsics, target, weight, eta,
                           mono_disps, scales, shifts, valid_depth_mask,
                           edges: EdgeSet, lm=1e-4, ep=0.1, alpha=0.01,
                           kx_mask=None):
    """One GN iteration of stage-2 DSPO; returns new (disps, scales,
    shifts), out of place. kx_mask (M,) bool: depth frames whose updates
    apply. CPU tensors take the plain version below, CUDA tensors the
    kernel (csrc/dspo.cu); `n.dspo.iter` counts the calls, `n.dspo.kernel`
    the launches."""
    tally("n.dspo.iter", 1)
    args = (poses, disps, intrinsics, target, weight, eta, mono_disps,
            scales, shifts, valid_depth_mask, edges, lm, ep, alpha, kx_mask)
    if disps.device.type == "cpu":
        return _scale_shift_iteration_torch(*args)
    out = dspo_cuda.scale_shift_iteration(*args)
    tally("n.dspo.kernel", 1)
    return out


def _scale_shift_iteration_torch(poses, disps, intrinsics, target, weight,
                                 eta, mono_disps, scales, shifts,
                                 valid_depth_mask, edges: EdgeSet, lm=1e-4,
                                 ep=0.1, alpha=0.01, kx_mask=None):
    """The plain version of _scale_shift_iteration."""
    h, w_ = disps.shape[-2:]
    HW = h * w_
    M, kx = edges.M, edges.kx
    sqrt_a = torch.sqrt(torch.tensor(alpha, dtype=disps.dtype,
                                     device=disps.device))
    _, _, _, Ck, wk = _edge_terms(poses, disps, intrinsics, target, weight,
                                  edges.ii, edges.jj)
    C_proj = Ck.new_zeros(M, HW).index_add_(0, edges.kk, Ck)
    w_proj = wk.new_zeros(M, HW).index_add_(0, edges.kk, wk)

    mono = mono_disps[kx].reshape(M, HW)
    d_k = disps[kx].reshape(M, HW)
    vmask = valid_depth_mask[kx].reshape(M, HW)
    sc = scales[kx][:, None]
    sh = shifts[kx][:, None]
    zero = torch.zeros_like(mono)

    invalid = mono < 1e-6
    r_d = sqrt_a * (d_k - (sc * mono + sh))
    sa = torch.where(vmask, sqrt_a * 10.0, sqrt_a.expand_as(mono))
    J_d = torch.where(invalid & vmask, zero, sa)
    J_s = torch.where(invalid, zero, -mono * sa)
    J_q = torch.where(invalid, zero, -sa)

    H00 = (J_s * J_s).sum(-1)
    H01 = (J_s * J_q).sum(-1)
    H11 = (J_q * J_q).sum(-1)
    u0 = -(J_s * r_d).sum(-1)
    u1 = -(J_q * r_d).sum(-1)

    C = C_proj + J_d * J_d + eta.reshape(M, HW)
    Q = torch.where(C != 0, 1.0 / torch.where(C != 0, C, torch.ones_like(C)),
                    zero)
    w = w_proj - J_d * r_d
    E0 = J_s * J_d
    E1 = J_q * J_d
    H00d = H00 + ep + lm * H00
    H11d = H11 + ep + lm * H11
    S00 = H00d - (E0 * Q * E0).sum(-1)
    S01 = H01 - (E0 * Q * E1).sum(-1)
    S11 = H11d - (E1 * Q * E1).sum(-1)
    r0 = u0 - (E0 * Q * w).sum(-1)
    r1 = u1 - (E1 * Q * w).sum(-1)

    det = S00 * S11 - S01 * S01
    safe = det.abs() > 1e-12
    det = torch.where(safe, det, torch.ones_like(det))
    dws = torch.where(safe, (S11 * r0 - S01 * r1) / det, torch.zeros_like(det))
    dq = torch.where(safe, (-S01 * r0 + S00 * r1) / det, torch.zeros_like(det))

    dz = Q * (w - (E0 * dws[:, None] + E1 * dq[:, None]))
    ok = torch.isfinite(dz).all(-1) & torch.isfinite(dws) & torch.isfinite(dq)
    if kx_mask is not None:
        ok = ok & kx_mask
    new_d = torch.where(ok[:, None], torch.clamp(d_k + dz, min=1e-5), d_k)
    disps = disps.clone()
    disps[kx] = new_d.reshape(M, h, w_)
    scales = scales.clone()
    shifts = shifts.clone()
    scales[kx] = scales[kx] + torch.where(ok, dws, torch.zeros_like(dws))
    shifts[kx] = shifts[kx] + torch.where(ok, dq, torch.zeros_like(dq))
    return disps, scales, shifts


def ba_scale_shift(poses, disps, intrinsics, target, weight, eta,
                   mono_disps, scales, shifts, valid_depth_mask,
                   edges: EdgeSet, iters: int = 1, lm: float = 1e-4,
                   ep: float = 0.1, alpha: float = 0.01):
    """Stage-2 of DSPO, poses frozen: disparities plus per-frame mono-prior
    scale w and shift q against the residual disps − (w·mono + q).
    Returns new (disps, scales, shifts)."""
    for _ in range(iters):
        disps, scales, shifts = _scale_shift_iteration(
            poses, disps, intrinsics, target, weight, eta, mono_disps,
            scales, shifts, valid_depth_mask, edges, lm, ep, alpha)
    return disps, scales, shifts


# ---------------------------------------------------------------------------
# closed-form weighted scale/shift alignment
# ---------------------------------------------------------------------------

def align_scale_and_shift(prediction, target, weights):
    """min Σ w·(s·pred + t − target)² over the last two dims; returns
    (scale, shift, avg_error). Degenerate fits give scale = shift = 0."""
    w = weights.to(prediction.dtype)
    dims = (-2, -1)
    a00 = (w * prediction * prediction).sum(dims)
    a01 = (w * prediction).sum(dims)
    a11 = w.sum(dims)
    b0 = (w * prediction * target).sum(dims)
    b1 = (w * target).sum(dims)
    det = a00 * a11 - a01 * a01
    ok = det > 0
    det_safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / det_safe, zero)
    shift = torch.where(ok, (-a01 * b0 + a00 * b1) / det_safe, zero)
    err = (scale[..., None, None] * prediction + shift[..., None, None]
           - target).abs()
    avg_error = (err * w).sum(dims) / torch.clamp(a11, min=1e-8)
    return scale, shift, avg_error
