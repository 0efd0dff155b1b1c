"""Stage 2 of DSPO in plain PyTorch: one Gauss-Newton iteration over the
disparities and each frame's mono-prior scale w and shift q, poses
frozen, against the residual disps − (w·mono + q); the depth eliminated
by a Schur complement, leaving one 2×2 system a frame.

Frozen copy of the port's `ops/ba._scale_shift_iteration`, taken when
the benchmark's DSPO check was written, over the reference's own
per-edge reductions (ba._edge_terms): it imports nothing of the program.
"""

from __future__ import annotations

import torch

from .ba import EdgeSet, _edge_terms


def scale_shift_iteration(poses, disps, intrinsics, target, weight, eta,
                          mono_disps, scales, shifts, valid_depth_mask,
                          edges: EdgeSet, lm=1e-4, ep=0.1, alpha=0.01,
                          kx_mask=None):
    """Returns new (disps, scales, shifts) in the inputs' precision.
    poses (B,7), disps/mono_disps (B,h,w), valid_depth_mask (B,h,w) bool,
    scales/shifts (B,), intrinsics (4,), target/weight (E,h,w,2), eta
    (M,h,w); kx_mask (M,) bool: the depth frames whose updates apply."""
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

    # the prior's residual and its Jacobians in d, w, q; pixels without a
    # prior keep only the disparity's own term
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
    S00 = H00 + ep + lm * H00 - (E0 * Q * E0).sum(-1)
    S01 = H01 - (E0 * Q * E1).sum(-1)
    S11 = H11 + ep + lm * H11 - (E1 * Q * E1).sum(-1)
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
    disps = disps.index_copy(0, kx, new_d.reshape(M, h, w_))
    scales = scales.index_copy(0, kx, scales[kx] + torch.where(
        ok, dws, torch.zeros_like(dws)))
    shifts = shifts.index_copy(0, kx, shifts[kx] + torch.where(
        ok, dq, torch.zeros_like(dq)))
    return disps, scales, shifts
