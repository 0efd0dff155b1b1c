"""Frozen copy of the port's plain `ops/ba.py`, taken when the
benchmark was written, for the benchmark's reference: it imports nothing
of the program, so a later change to the program does not change it.

Stage-1 dense bundle adjustment (DBA): Gauss-Newton over keyframe poses
and 1/8-res disparities, depth eliminated by a Schur complement, and the
damped Cholesky solve that returns zeros when it fails. The pose/depth
coupling E is held dense per (depth frame, pose slot), so S = E Q Eᵀ is
one batched matmul.
"""

from __future__ import annotations

import dataclasses

import torch

from . import lie
from . import projective as pops


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

    @property
    def P(self):
        return self.t1 - self.t0

    @property
    def M(self):
        return self.kx.shape[0]


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
