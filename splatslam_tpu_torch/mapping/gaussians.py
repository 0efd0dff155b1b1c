"""Gaussian map storage + optimizer, fixed capacity with an alive mask
(counterpart of splatslam_tpu/mapping/gaussians.py).

The map lives in capacity-padded tensors: densify writes clones/splits
into free slots, prune clears the mask, Adam moments are zeroed at
touched slots, and capacity grows by doubling. Parameters mirror the
reference: xyz, f_dc/f_rest (SH), log-scaling, wxyz rotation, logit
opacity, plus the anchoring keyframe id per Gaussian.

`adam_step` updates the state in place (the parameter tensors are the
autograd leaves of the mapping step); every other function returns a
new state and leaves its input untouched.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device

C0 = 0.28209479177387814  # SH DC basis

PARAM_NAMES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianState:
    """All per-Gaussian tensors, capacity-padded (same field names as the
    JAX GaussianState)."""
    xyz: torch.Tensor          # (C, 3)
    f_dc: torch.Tensor         # (C, 3)
    f_rest: torch.Tensor       # (C, R, 3)
    opacity: torch.Tensor      # (C, 1) logit
    scaling: torch.Tensor      # (C, 3) log
    rotation: torch.Tensor     # (C, 4) wxyz
    alive: torch.Tensor        # (C,) bool
    kf_id: torch.Tensor        # (C,) int32
    n_obs: torch.Tensor        # (C,) int32
    max_radii2D: torch.Tensor  # (C,)
    grad_accum: torch.Tensor   # (C,)
    denom: torch.Tensor        # (C,)
    m_xyz: torch.Tensor
    v_xyz: torch.Tensor
    m_f_dc: torch.Tensor
    v_f_dc: torch.Tensor
    m_f_rest: torch.Tensor
    v_f_rest: torch.Tensor
    m_opacity: torch.Tensor
    v_opacity: torch.Tensor
    m_scaling: torch.Tensor
    v_scaling: torch.Tensor
    m_rotation: torch.Tensor
    v_rotation: torch.Tensor

    @property
    def capacity(self):
        return self.xyz.shape[0]

    @property
    def device(self):
        return self.xyz.device

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(GaussianState))


def make_state(capacity: int, sh_degree: int = 0, device=None):
    """Empty capacity-padded state; `device` None is the GPU
    (resolve_device)."""
    device = resolve_device(device)
    R = (sh_degree + 1) ** 2 - 1
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    rot = z(capacity, 4)
    rot[:, 0] = 1.0
    return GaussianState(
        xyz=z(capacity, 3), f_dc=z(capacity, 3), f_rest=z(capacity, R, 3),
        opacity=z(capacity, 1), scaling=z(capacity, 3), rotation=rot,
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
        kf_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        n_obs=torch.zeros(capacity, dtype=torch.int32, device=device),
        max_radii2D=z(capacity), grad_accum=z(capacity), denom=z(capacity),
        m_xyz=z(capacity, 3), v_xyz=z(capacity, 3),
        m_f_dc=z(capacity, 3), v_f_dc=z(capacity, 3),
        m_f_rest=z(capacity, R, 3), v_f_rest=z(capacity, R, 3),
        m_opacity=z(capacity, 1), v_opacity=z(capacity, 1),
        m_scaling=z(capacity, 3), v_scaling=z(capacity, 3),
        m_rotation=z(capacity, 4), v_rotation=z(capacity, 4))


# -- activations -------------------------------------------------------------

def get_scaling(st):
    return torch.exp(st.scaling)


def get_opacity(st):
    return torch.sigmoid(st.opacity)


def get_rotation(st):
    return st.rotation / torch.linalg.norm(st.rotation, dim=-1, keepdim=True)


def get_colors_dc(st):
    return torch.clamp(sh_to_rgb(st.f_dc), min=0.0)


# -- KNN scale init ----------------------------------------------------------

def num_alive(st) -> int:
    return int(st.alive.sum())


def mean_sq_dist_3nn(points, valid, row_chunk=512):
    """Mean squared distance to the 3 nearest valid neighbors (simple-knn
    distCUDA2 equivalent), in row chunks to bound memory."""
    n = points.shape[0]
    big = 1e12
    out = []
    for r0 in range(0, n, row_chunk):
        p = points[r0:r0 + row_chunk]
        d2 = ((p[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        rows = torch.arange(r0, r0 + p.shape[0], device=points.device)
        d2[torch.arange(p.shape[0], device=points.device), rows] += big
        d2 = torch.where(valid[None, :], d2, torch.full_like(d2, big))
        d3 = torch.topk(d2, min(3, n), dim=1, largest=False).values
        ok = d3 < 0.5 * big
        cnt = ok.sum(-1)
        mean = torch.where(ok, d3, 0.0).sum(-1) / torch.clamp(cnt, min=1)
        out.append(torch.where(cnt > 0, mean, torch.full_like(mean, 1e-6)))
    return torch.cat(out)


# -- anchoring ---------------------------------------------------------------

def anchor_points(image, depth, w2c, intrinsics, downsample, point_size,
                  max_new, generator=None, uniform=None):
    """New Gaussian candidates from a keyframe: unproject the proxy depth,
    keep each pixel with probability 1/downsample, pad to max_new.

    The keep draws come from `uniform` (H·W,) when given (tests feed both
    packages the same numbers), else from `generator`."""
    H, W = depth.shape
    dev = depth.device
    fx, fy, cx, cy = intrinsics.unbind(0)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    z = depth.reshape(-1)
    if uniform is None:
        uniform = torch.rand(H * W, generator=generator, device=dev)
    valid = (z > 1e-6) & (uniform < (1.0 / downsample))
    X = (xs.reshape(-1) - cx) / fx * z
    Y = (ys.reshape(-1) - cy) / fy * z
    pts_cam = torch.stack([X, Y, z], -1)
    c2w = torch.linalg.inv(w2c)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = image.reshape(-1, 3)
    order = torch.sort((~valid).to(torch.int8), stable=True).indices
    idx = order[:max_new]
    ok = valid[idx]
    pts = pts[idx]
    cols = cols[idx]
    dist2 = torch.clamp(mean_sq_dist_3nn(pts, ok), min=1e-7) * point_size
    scales = 0.5 * torch.log(dist2)[:, None].repeat(1, 3)
    return dict(xyz=pts, color=cols, scales=scales, valid=ok,
                count=ok.sum())


def _scatter_rows(arr, tgt, vals):
    """arr with rows tgt ← vals; tgt == C rows are dropped."""
    C = arr.shape[0]
    out = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])], 0)
    out[tgt] = vals.to(arr.dtype)
    return out[:C]


def _free_slots(alive):
    """Free slot indices first, in index order (stable argsort of alive)."""
    return torch.sort(alive.to(torch.int8), stable=True).indices


def insert_points(st: GaussianState, new, kf_id):
    """Write anchored points into free slots (new slots start with zero
    Adam moments)."""
    C = st.capacity
    dev = st.device
    slot_of_free = _free_slots(st.alive)
    n_new = new["valid"].shape[0]
    new_rank = torch.cumsum(new["valid"].to(torch.int64), 0) - 1
    target = slot_of_free[torch.clamp(new_rank, 0, C - 1)]
    write = new["valid"] & (new_rank < (~st.alive).sum())
    tgt = torch.where(write, target, torch.full_like(target, C))
    R = st.f_rest.shape[1]
    zeros = lambda *s: torch.zeros((n_new,) + s, device=dev)
    rot = zeros(4)
    rot[:, 0] = 1.0
    upd = dict(
        xyz=new["xyz"], f_dc=rgb_to_sh(new["color"]), f_rest=zeros(R, 3),
        opacity=zeros(1), scaling=new["scales"], rotation=rot,
        alive=torch.ones(n_new, dtype=torch.bool, device=dev),
        kf_id=torch.full((n_new,), int(kf_id), dtype=torch.int32,
                         device=dev),
        n_obs=torch.zeros(n_new, dtype=torch.int32, device=dev),
        max_radii2D=zeros(), grad_accum=zeros(), denom=zeros())
    for name in PARAM_NAMES:
        for pre in ("m_", "v_"):
            upd[pre + name] = torch.zeros_like(upd[name], dtype=torch.float32)
    return st.replace(**{k: _scatter_rows(getattr(st, k), tgt, v)
                         for k, v in upd.items()})


def grow_capacity(st: GaussianState, factor: int = 2) -> GaussianState:
    C = st.capacity
    extra = make_state(C * (factor - 1), device=st.device)
    R = st.f_rest.shape[1]
    if R != extra.f_rest.shape[1]:
        z = torch.zeros((C * (factor - 1), R, 3), device=st.device)
        extra = extra.replace(f_rest=z, m_f_rest=z, v_f_rest=z)
    return GaussianState(**{k: torch.cat([getattr(st, k), getattr(extra, k)])
                            for k in FIELDS})


# -- Adam (torch.optim.Adam(eps=1e-15) semantics) ----------------------------

def bias_corrections(step, b1=0.9, b2=0.999):
    """Adam's bias corrections (1 - b1^t, 1 - b2^t) at the 1-based `step`
    t, in double on the host."""
    t = float(step)
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def graph_factor(bc):
    """The float32 reciprocal of a bias correction: what a CUDA kernel
    multiplies a float32 tensor by when it divides it by the Python number
    `bc`. A step captured in a CUDA graph reads it from device memory."""
    return float(np.float32(1.0) / np.float32(bc))


def unbias(x, bc):
    """x over its bias correction: `bc` a number (bias_corrections), or a
    0-d device tensor holding graph_factor(bc), so that a replayed step and
    an eager one agree bit for bit on the card."""
    return x * bc if torch.is_tensor(bc) else x / bc


@torch.no_grad()
def adam_step(st: GaussianState, grads: dict, lrs: dict, step,
              b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step on all Gaussian parameters, IN PLACE. grads/lrs keyed
    by PARAM_NAMES; `step` is the 1-based step count (bias correction)."""
    return adam_update(st, grads, lrs, *bias_corrections(step, b1, b2), b1,
                       b2, eps)


@torch.no_grad()
def adam_update(st, grads: dict, lrs: dict, bc1, bc2, b1=0.9, b2=0.999,
                eps=1e-15):
    """adam_step with its bias corrections given (unbias). The learning
    rates and the corrections are numbers, or 0-d device tensors that a
    step captured in a CUDA graph reads afresh at each replay."""
    for name in PARAM_NAMES:
        g = grads[name]
        g = torch.where(st.alive.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                        0.0)
        m = getattr(st, f"m_{name}")
        v = getattr(st, f"v_{name}")
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        getattr(st, name).sub_(lrs[name] * unbias(m, bc1)
                               / (torch.sqrt(unbias(v, bc2)) + eps))
    return st


def xyz_lr(step, lr_init, lr_final, lr_delay_mult, max_steps):
    """Exponential xyz schedule (delay ramp off: the mapper sets no delay
    steps)."""
    del lr_delay_mult
    t = min(max(float(step) / max_steps, 0.0), 1.0)
    return float(np.exp(np.log(np.float32(lr_init)) * (1 - t)
                        + np.log(np.float32(lr_final)) * t))


# -- densify / prune / opacity resets -----------------------------------------

def _zero_moments(st, slots_mask):
    upd = {}
    for name in PARAM_NAMES:
        for pre in ("m_", "v_"):
            arr = getattr(st, pre + name)
            msk = slots_mask.reshape((-1,) + (1,) * (arr.dim() - 1))
            upd[pre + name] = torch.where(msk, 0.0, arr)
    return st.replace(**upd)


def densify_and_prune(st: GaussianState, max_grad, min_opacity, extent,
                      max_screen_size, percent_dense=0.01, N: int = 2,
                      generator=None, noise=None):
    """Clone + split + prune in the padded arrays. Splits sample N
    children around each large parent from standard-normal `noise`
    (N, C, 3) — given by tests, else drawn from `generator`."""
    C = st.capacity
    dev = st.device
    grads = torch.where(st.denom > 0, st.grad_accum / st.denom, 0.0)
    scal = get_scaling(st)
    smax = scal.max(-1).values
    clone_mask = st.alive & (grads >= max_grad) & (smax <= percent_dense * extent)
    split_mask = st.alive & (grads >= max_grad) & (smax > percent_dense * extent)

    parent_mask = clone_mask | split_mask
    nz = torch.nonzero(parent_mask)[:, 0]
    parent_idx = torch.full((C,), C, dtype=torch.int64, device=dev)
    parent_idx[:nz.shape[0]] = nz
    is_parent = parent_idx < C
    pidx = torch.clamp(parent_idx, 0, C - 1)
    gather = lambda a: a[pidx]
    if noise is None:
        noise = torch.randn((N, C, 3), generator=generator, device=dev)

    q = gather(get_rotation(st))
    w, x, y, z = q.unbind(-1)
    Rm = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    is_split = gather(split_mask)
    children = []
    for b in range(N):
        nb = noise[b] * gather(scal)
        split_xyz = gather(st.xyz) + torch.einsum("nij,nj->ni", Rm, nb)
        split_scaling = torch.log(gather(scal) / (0.8 * N))
        is_clone = gather(clone_mask) & (b == 0)
        children.append(dict(
            xyz=torch.where(is_split[:, None], split_xyz, gather(st.xyz)),
            scaling=torch.where(is_split[:, None], split_scaling,
                                gather(st.scaling)),
            f_dc=gather(st.f_dc), f_rest=gather(st.f_rest),
            opacity=gather(st.opacity), rotation=gather(st.rotation),
            kf_id=gather(st.kf_id), n_obs=gather(st.n_obs),
            valid=is_parent & (is_split | is_clone)))
    cat = {k: torch.cat([c[k] for c in children], 0) for k in children[0]}

    st = st.replace(alive=st.alive & ~split_mask)
    slot_of_free = _free_slots(st.alive)
    n_free = (~st.alive).sum()
    rank = torch.cumsum(cat["valid"].to(torch.int64), 0) - 1
    tgt = torch.where(cat["valid"] & (rank < n_free),
                      slot_of_free[torch.clamp(rank, 0, C - 1)],
                      torch.full_like(rank, C))
    newly = _scatter_rows(torch.zeros(C, dtype=torch.bool, device=dev), tgt,
                          cat["valid"])
    st = st.replace(
        **{k: _scatter_rows(getattr(st, k), tgt, cat[k])
           for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling",
                     "rotation", "kf_id", "n_obs")},
        alive=st.alive | newly)
    st = _zero_moments(st, newly)
    st = st.replace(max_radii2D=torch.where(newly, 0.0, st.max_radii2D))

    prune = st.alive & (get_opacity(st)[:, 0] < min_opacity)
    if max_screen_size is not None:
        big_vs = st.max_radii2D > max_screen_size
        big_ws = get_scaling(st).max(-1).values > 0.1 * extent
        prune = prune | (st.alive & (big_vs | big_ws))
    return st.replace(alive=st.alive & ~prune,
                      grad_accum=torch.zeros_like(st.grad_accum),
                      denom=torch.zeros_like(st.denom))


def _zero_moments_only(st, name):
    return st.replace(**{f"m_{name}": torch.zeros_like(getattr(st, f"m_{name}")),
                         f"v_{name}": torch.zeros_like(getattr(st, f"v_{name}"))})


def reset_opacity(st: GaussianState, value=0.01):
    """opacity ← min(opacity, logit(value)); never raises an opacity."""
    cap = float(np.log(value / (1 - value)))
    st = st.replace(opacity=torch.clamp(st.opacity, max=cap))
    return _zero_moments_only(st, "opacity")


def reset_opacity_nonvisible(st: GaussianState, visible_any):
    """Opacity of Gaussians not visible in the window ← 0.4."""
    cur = get_opacity(st)
    tgt = torch.where(visible_any[:, None], cur, torch.full_like(cur, 0.4))
    st = st.replace(opacity=inverse_sigmoid(torch.clamp(tgt, 1e-4, 1 - 1e-4)))
    return _zero_moments_only(st, "opacity")


def prune_by_mask(st: GaussianState, mask):
    return st.replace(alive=st.alive & ~mask)


# -- PLY output ----------------------------------------------------------------

def save_ply(st: GaussianState, path: str):
    """Binary little-endian PLY with the reference attribute list."""
    alive = st.alive.cpu().numpy()
    host = lambda a: a.detach().cpu().numpy()[alive]
    xyz = host(st.xyz)
    n = xyz.shape[0]
    f_dc = host(st.f_dc)
    f_rest = host(st.f_rest).transpose(0, 2, 1).reshape(
        n, st.f_rest.shape[1] * 3)
    opa, scal, rot = host(st.opacity), host(st.scaling), host(st.rotation)
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scal.shape[1])]
             + [f"rot_{i}" for i in range(rot.shape[1])])
    data = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, opa, scal,
                           rot], axis=1).astype("<f4")
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names] + ["end_header"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(data.tobytes())


def load_ply(path: str, capacity: int | None = None,
             device=None) -> GaussianState:
    """Load a (reference-format) Gaussian PLY into a padded state on
    `device` (None is the GPU): the inverse of save_ply."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(l.split()[-1]) for l in header
                 if l.startswith("element vertex"))
        props = [l.split()[-1] for l in header if l.startswith("property")]
        data = np.frombuffer(f.read(), dtype="<f4").reshape(n, len(props))
    col = {p: data[:, i] for i, p in enumerate(props)}
    n_rest = sum(1 for p in props if p.startswith("f_rest_"))
    R = n_rest // 3
    if capacity is None:
        capacity = max(2 * n, 1024)
    st = make_state(capacity, sh_degree=int(np.sqrt(R + 1)) - 1 if R else 0,
                    device=device)
    cols = lambda names: torch.as_tensor(
        np.stack([col[k] for k in names], -1), device=st.device)
    st.xyz[:n] = cols(["x", "y", "z"])
    st.f_dc[:n] = cols([f"f_dc_{i}" for i in range(3)])
    if n_rest:
        # channel-major on disk (k = c*R + r), (n, R, 3) in the state
        st.f_rest[:n] = cols([f"f_rest_{i}" for i in range(n_rest)]).reshape(
            n, 3, R).transpose(1, 2)
    st.opacity[:n] = cols(["opacity"])
    st.scaling[:n] = cols([f"scale_{i}" for i in range(3)])
    st.rotation[:n] = cols([f"rot_{i}" for i in range(4)])
    st.alive[:n] = True
    st.kf_id[:n] = 0
    return st
