"""Frozen copy of the port's plain `ops/lie.py`, taken when the
benchmark was written, for the benchmark's reference: it imports nothing
of the program, so a later change to the program does not change it.

SE(3) / Sim(3) Lie-group operations on quaternion 7/8-vectors, in
PyTorch (counterpart of splatslam_tpu/ops/lie.py).

Storage layout (lietorch-compatible):
    SE3  : [tx, ty, tz, qx, qy, qz, qw]            (7 floats)
    Sim3 : [tx, ty, tz, qx, qy, qz, qw, s]         (8 floats)
Tangent layout: [tau(3), phi(3)] (+ sigma for Sim3). Retraction is LEFT
multiplication: retr(g, xi) = exp(xi) ∘ g. Group action on homogeneous
4-points X = (x, y, z, d): g * X = (R @ (x,y,z) + d * t, d).

All functions broadcast over leading batch dimensions and are
autograd-safe (Taylor branches near the identity).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    out[..., 6] = 1.0
    return out


# -- quaternion helpers (xyzw, Hamilton) ------------------------------------

def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def quat_rotate(q, v):
    qv, qw = q[..., :3], q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) → unit quaternion xyzw (Shepperd's
    method, best-conditioned candidate per element, qw ≥ 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], -2)          # (..., cand, wxyz)
    diag = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                        1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(diag, -1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    cand = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.cat([cand[..., 1:4], cand[..., 0:1]], -1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.sign(q[..., 3:4] + _EPS)


# -- SO(3) ------------------------------------------------------------------

def _sinc(x):
    small = torch.abs(x) < 1e-4
    return torch.where(small, 1.0 - x * x / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def _safe_norm(v, keepdim=False):
    return torch.sqrt(torch.sum(v * v, -1, keepdim=keepdim) + 1e-24)


def so3_exp_quat(phi):
    theta = _safe_norm(phi, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-4
    k = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(theta),
                                                  theta))
    return torch.cat([k * phi, torch.cos(half)], -1)


def so3_log(q):
    sign = torch.sign(q[..., 3:4] + _EPS)
    qv = q[..., :3] * sign
    qw = q[..., 3:4] * sign
    n = _safe_norm(qv, keepdim=True)
    half = torch.atan2(n, qw)
    small = n < 1e-6
    k = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS),
                    2.0 * half / torch.where(small, torch.ones_like(n), n))
    return k * qv


def _hat(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def _so3_left_jacobian(phi):
    theta = _safe_norm(phi)
    W = _hat(phi)
    W2 = W @ W
    small = theta < 1e-4
    t = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 0.5 - theta ** 2 / 24.0, (1.0 - torch.cos(t)) / t ** 2)
    B = torch.where(small, 1.0 / 6.0 - theta ** 2 / 120.0,
                    (t - torch.sin(t)) / t ** 3)
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def _so3_left_jacobian_inv(phi):
    theta = _safe_norm(phi)
    W = _hat(phi)
    W2 = W @ W
    small = theta < 1e-4
    t = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * t
    cot = torch.where(small, 1.0 / 12.0 + theta ** 2 / 720.0,
                      (1.0 - half * torch.cos(half) / torch.sin(half)) / t ** 2)
    return _eye3(W) - 0.5 * W + cot[..., None, None] * W2


# -- SE(3) ------------------------------------------------------------------

def mul(g1, g2):
    t1, q1 = g1[..., :3], g1[..., 3:7]
    t2, q2 = g2[..., :3], g2[..., 3:7]
    q1, q2 = torch.broadcast_tensors(q1, q2)
    return torch.cat([t1 + quat_rotate(q1, t2), quat_mul(q1, q2)], -1)


def inv(g):
    t, q = g[..., :3], g[..., 3:7]
    qi = quat_conj(q)
    return torch.cat([-quat_rotate(qi, t), qi], -1)


def act(g, X):
    """Apply SE3 to homogeneous 4-points (x, y, z, d): (R xyz + d t, d)."""
    t, q = g[..., :3], g[..., 3:7]
    xyz, d = X[..., :3], X[..., 3:4]
    out = quat_rotate(q, xyz) + d * t
    return torch.cat([out, d.expand(out.shape[:-1] + (1,))], -1)


def act3(g, p):
    return quat_rotate(g[..., 3:7], p) + g[..., :3]


def exp(xi):
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    t = torch.einsum("...ij,...j->...i", _so3_left_jacobian(phi), tau)
    return torch.cat([t, q], -1)


def log(g):
    t, q = g[..., :3], g[..., 3:7]
    phi = so3_log(q)
    tau = torch.einsum("...ij,...j->...i", _so3_left_jacobian_inv(phi), t)
    return torch.cat([tau, phi], -1)


def retr(g, xi):
    return mul(exp(xi), g)


def adjoint(g):
    """Adj(g) (..., 6, 6) for tangent order [tau, phi]."""
    t, q = g[..., :3], g[..., 3:7]
    R = quat_to_matrix(q)
    tR = _hat(t) @ R
    top = torch.cat([R, tR], -1)
    bot = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bot], -2)


def adjT_apply(g, Jrows):
    """J ← J @ Adj(g) (lietorch adjT on Jacobian row-covectors)."""
    return torch.einsum("...kj,...ji->...ki", Jrows, adjoint(g))


def to_matrix(g):
    t, q = g[..., :3], g[..., 3:7]
    R = quat_to_matrix(q)
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def from_matrix(T):
    return torch.cat([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])], -1)


def from_matrix_np(T) -> np.ndarray:
    """Host (numpy) 4×4 → SE3 7-vec (per-frame host logic)."""
    T = np.asarray(T)
    R = T[:3, :3]
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw])
    q = q / np.linalg.norm(q)
    return np.concatenate([T[:3, 3], q]).astype(np.float32)


def inv_matrix_np(g) -> np.ndarray:
    """Host batched c2w 4×4 matrices from w2c SE3 7-vecs."""
    g = np.atleast_2d(np.asarray(g, np.float64))
    t, q = g[:, :3], g[:, 3:7]
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((g.shape[0], 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    out = np.tile(np.eye(4), (g.shape[0], 1, 1))
    out[:, :3, :3] = R.transpose(0, 2, 1)
    out[:, :3, 3] = -np.einsum("nji,nj->ni", R, t)
    return out.astype(np.float32)


def normalize(g):
    t, q = g[..., :3], g[..., 3:7]
    return torch.cat([t, q / torch.linalg.norm(q, dim=-1, keepdim=True)], -1)


# -- Sim(3): 8-vec [t, q, s]; tangent [tau, phi, sigma] ---------------------

def sim3_identity(shape=(), dtype=torch.float32, device=None):
    out = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    out[..., 6] = 1.0
    out[..., 7] = 1.0
    return out


def sim3_mul(g1, g2):
    t1, q1, s1 = g1[..., :3], g1[..., 3:7], g1[..., 7:8]
    t2, q2, s2 = g2[..., :3], g2[..., 3:7], g2[..., 7:8]
    return torch.cat([t1 + s1 * quat_rotate(q1, t2), quat_mul(q1, q2),
                      s1 * s2], -1)


def sim3_inv(g):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qi = quat_conj(q)
    si = 1.0 / s
    return torch.cat([-si * quat_rotate(qi, t), qi, si], -1)


def sim3_act(g, X):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    xyz, d = X[..., :3], X[..., 3:4]
    return torch.cat([s * quat_rotate(q, xyz) + d * t, d], -1)


def _sim3_W(sigma, phi):
    """W(σ, φ) = ∫₀¹ e^{uσ} e^{uΦ} du, the Sim(3) translation Jacobian
    (closed form with Taylor branches, as in the JAX package)."""
    theta = _safe_norm(phi)
    s = torch.exp(sigma)
    Phi = _hat(phi)
    Phi2 = Phi @ Phi
    th2 = theta * theta
    sig2 = sigma * sigma
    den = sig2 + th2
    one = torch.ones_like(sigma)

    small_sig = torch.abs(sigma) < 1e-4
    sig_safe = torch.where(small_sig, one, sigma)
    C = torch.where(small_sig, 1.0 + 0.5 * sigma + sig2 / 6.0,
                    (s - 1.0) / sig_safe)
    small_den = den < 1e-8
    den_safe = torch.where(small_den, one, den)
    A = torch.where(small_den, 0.5 + sigma / 3.0 - th2 / 24.0,
                    (1.0 - s * torch.cos(theta) + s * sigma * _sinc(theta))
                    / den_safe)
    I2 = (s * (sigma * torch.cos(theta) + theta * torch.sin(theta)) - sigma) \
        / den_safe
    small_th = th2 < 1e-8
    th2_safe = torch.where(small_th, one, th2)
    B_small_th = torch.where(
        small_sig, 1.0 / 6.0 + sigma / 8.0 + sig2 / 20.0,
        (s * (sig2 - 2.0 * sigma + 2.0) - 2.0) / (2.0 * sig_safe ** 3))
    B = torch.where(small_th, B_small_th, (C - I2) / th2_safe)
    return (C[..., None, None] * _eye3(Phi) + A[..., None, None] * Phi
            + B[..., None, None] * Phi2)


def sim3_exp(xi):
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    q = so3_exp_quat(phi)
    t = torch.einsum("...ij,...j->...i", _sim3_W(sigma, phi), tau)
    return torch.cat([t, q, torch.exp(sigma)[..., None]], -1)


def sim3_log(g):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7]
    phi = so3_log(q)
    sigma = torch.log(s)
    tau = torch.linalg.solve(_sim3_W(sigma, phi), t[..., None])[..., 0]
    return torch.cat([tau, phi, sigma[..., None]], -1)


def sim3_retr(g, xi):
    return sim3_mul(sim3_exp(xi), g)


def sim3_adjoint(g):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7]
    R = quat_to_matrix(q)
    tR = _hat(t) @ R
    top = torch.cat([s[..., None, None] * R, tR, -t[..., None]], -1)
    mid = torch.cat([torch.zeros_like(R), R, torch.zeros_like(t[..., None])], -1)
    bot = torch.zeros_like(mid[..., :1, :])
    bot[..., 0, 6] = 1.0
    return torch.cat([top, mid, bot], -2)


def sim3_to_matrix(g):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    R = quat_to_matrix(q) * s[..., None]
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)
