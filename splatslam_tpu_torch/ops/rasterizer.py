"""Differentiable 3D Gaussian Splatting rasterizer in PyTorch (counterpart
of splatslam_tpu/ops/rasterizer.py).

Projection + EWA splatting, tile binning and the camera-pose gradients are
plain PyTorch with autograd. Per-tile front-to-back compositing is a
`torch.autograd.Function` whose forward and backward are the hand-written
CUDA kernels B1/B2 (ops/raster_cuda.py) on CUDA tensors and the plain
versions `composite_fwd_torch` / `composite_bwd_torch` below on CPU
tensors.

Static-shape conventions kept from the JAX package: a capacity-padded
Gaussian set with an alive mask, a fixed 16×16 tile grid, at most K
depth-ordered contributors per tile, and binning by one sort of packed
(tile, quantised depth) keys.
"""

from __future__ import annotations

import dataclasses

import torch

from . import lie
from . import raster_cuda

TILE = 16
NPIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
MAX_ALPHA = 0.99
_KEY_PAD = 2 ** 31 - 1

# calls of the plain compositing versions (CPU path, or comparisons)
plain_calls = {"composite_fwd": 0, "composite_bwd": 0}


# ---------------------------------------------------------------------------
# projection + EWA splatting
# ---------------------------------------------------------------------------

def project_gaussians(means3D, scales, rotations, w2c, intrinsics, H, W,
                      near=0.01):
    """Project Gaussians into a batch of cameras.

    means3D/scales (N,3); rotations (N,4) wxyz; w2c (B,4,4); intrinsics
    (4,) tensor (fx, fy, cx, cy). Returns (means2d (B,N,2), depth (B,N),
    conic (B,N,3), radius (B,N), in_front (B,N)). Structure-of-arrays
    arithmetic in the same order as the JAX package."""
    fx, fy, cx, cy = intrinsics.unbind(0)
    R = w2c[:, :3, :3]
    t = w2c[:, :3, 3]
    r = lambda i, j: R[:, i, j, None]
    m0, m1, m2 = means3D[None, :, 0], means3D[None, :, 1], means3D[None, :, 2]
    x = r(0, 0) * m0 + r(0, 1) * m1 + r(0, 2) * m2 + t[:, 0, None]
    y = r(1, 0) * m0 + r(1, 1) * m1 + r(1, 2) * m2 + t[:, 1, None]
    z = r(2, 0) * m0 + r(2, 1) * m1 + r(2, 2) * m2 + t[:, 2, None]
    in_front = z > near
    zc = torch.where(in_front, z, torch.ones_like(z))

    u = fx * x / zc + cx
    v = fy * y / zc + cy
    means2d = torch.stack([u, v], -1)

    lim_x = 1.3 * (0.5 * W / fx)
    lim_y = 1.3 * (0.5 * H / fy)
    txz = torch.maximum(torch.minimum(x / zc, lim_x), -lim_x)
    tyz = torch.maximum(torch.minimum(y / zc, lim_y), -lim_y)

    j00 = fx / zc
    j02 = -fx * txz / zc
    j11 = fy / zc
    j12 = -fy * tyz / zc
    a00 = j00 * r(0, 0) + j02 * r(2, 0)
    a01 = j00 * r(0, 1) + j02 * r(2, 1)
    a02 = j00 * r(0, 2) + j02 * r(2, 2)
    a10 = j11 * r(1, 0) + j12 * r(2, 0)
    a11 = j11 * r(1, 1) + j12 * r(2, 1)
    a12 = j11 * r(1, 2) + j12 * r(2, 2)

    q = rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)
    qw, qx, qy, qz = [c[None] for c in q.unbind(-1)]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0, s1, s2 = scales[None, :, 0], scales[None, :, 1], scales[None, :, 2]

    b00 = (a00 * r00 + a01 * r10 + a02 * r20) * s0
    b01 = (a00 * r01 + a01 * r11 + a02 * r21) * s1
    b02 = (a00 * r02 + a01 * r12 + a02 * r22) * s2
    b10 = (a10 * r00 + a11 * r10 + a12 * r20) * s0
    b11 = (a10 * r01 + a11 * r11 + a12 * r21) * s1
    b12 = (a10 * r02 + a11 * r12 + a12 * r22) * s2

    c_a = b00 * b00 + b01 * b01 + b02 * b02 + 0.3
    c_b = b00 * b10 + b01 * b11 + b02 * b12
    c_c = b10 * b10 + b11 * b11 + b12 * b12 + 0.3

    det = c_a * c_c - c_b * c_b
    det = torch.where(det > 1e-12, det, torch.full_like(det, 1e-12))
    conic = torch.stack([c_c / det, -c_b / det, c_a / det], -1)

    mid = 0.5 * (c_a + c_c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    radius = torch.where(in_front, radius, torch.zeros_like(radius))
    return means2d, z, conic, radius, in_front


def _project_cameras(means3D, scales, rotations, alive, w2cs, taus,
                     intrinsics, H, W, near):
    """Retract the pose deltas (w2c ← exp(tau) ∘ w2c) and project."""
    w2c_t = lie.to_matrix(lie.exp(taus)) @ w2cs
    means2d, depth_z, conic, radius, in_front = project_gaussians(
        means3D, scales, rotations, w2c_t, intrinsics, H, W, near)
    return means2d, depth_z, conic, radius, in_front & alive[None]


def _bin_radius(radius, opacities, margin=0.0):
    """Alpha-cutoff shrink of the 3σ binning radius (+ optional margin)."""
    opa_c = torch.clamp(opacities, 0.0, 1.0)
    cut = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * opa_c), min=0.0))
    r = radius * torch.clamp(cut / 3.0, max=1.0)[None]
    if margin:
        r = torch.where(r > 0, r + margin, torch.zeros_like(r))
    return r


# ---------------------------------------------------------------------------
# tile binning: duplicate into tiles + one stable sort of packed keys
# ---------------------------------------------------------------------------

def bin_gaussians_batch(means2d, radius, depth, visible, n_tiles_x,
                        n_tiles_y, K, max_span=4):
    """Per-tile depth-ordered contributor lists for a camera batch.

    means2d (B,N,2); radius/depth/visible (B,N). Returns (tile_ids
    (B,T,K) int32, -1 padding; counts (B,T) int32 including overflow
    beyond K). The key packs a 16-bit depth quantisation below the tile
    id; torch.sort(stable=True) orders equal keys by Gaussian index."""
    B, N = means2d.shape[:2]
    T = n_tiles_x * n_tiles_y
    dev = means2d.device
    if (T + 1) < (1 << 15):
        inf = torch.full_like(depth, float("inf"))
        dmin = torch.where(visible, depth, inf).amin(1, keepdim=True)
        dmax = torch.where(visible, depth, -inf).amax(1, keepdim=True)
        dmin = torch.where(torch.isfinite(dmin), dmin, torch.zeros_like(dmin))
        dmax = torch.where(torch.isfinite(dmax), dmax, torch.ones_like(dmax))
        scale = 65535.0 / torch.clamp(dmax - dmin, min=1e-9)
        rank = torch.clamp((depth - dmin) * scale, 0, 65535).to(torch.int64)
        KEYB = 1 << 16
    else:
        if (T + 1) * N >= 2 ** 31:
            raise ValueError(
                f"tile-sort key overflow: tiles({T})·capacity({N}) must "
                "be < 2^31; reduce the Gaussian capacity or image size")
        d = torch.where(visible, depth, torch.full_like(depth, float("inf")))
        order = torch.sort(d, dim=1, stable=True).indices
        rank = torch.sort(order, dim=1, stable=True).indices
        KEYB = N

    u, v = means2d[..., 0], means2d[..., 1]
    fl = lambda a, hi: torch.clamp(torch.floor(a / TILE), 0, hi - 1)
    x0, x1 = fl(u - radius, n_tiles_x), fl(u + radius, n_tiles_x)
    y0, y1 = fl(v - radius, n_tiles_y), fl(v + radius, n_tiles_y)
    on_img = ((u + radius >= 0) & (u - radius < n_tiles_x * TILE)
              & (v + radius >= 0) & (v - radius < n_tiles_y * TILE))
    ok = visible & (radius > 0) & on_img
    x0, x1, y0, y1 = [a.to(torch.int64) for a in (x0, x1, y0, y1)]

    ctx = torch.minimum(torch.maximum(torch.floor(u / TILE).to(torch.int64),
                                      x0), x1)
    cty = torch.minimum(torch.maximum(torch.floor(v / TILE).to(torch.int64),
                                      y0), y1)
    half = (max_span - 1) // 2
    sx = torch.minimum(torch.maximum(ctx - half, x0),
                       torch.maximum(x1 - max_span + 1, x0))
    sy = torch.minimum(torch.maximum(cty - half, y0),
                       torch.maximum(y1 - max_span + 1, y0))

    offs = torch.arange(max_span, device=dev)
    tx = sx[..., None] + offs                      # (B, N, S)
    ty = sy[..., None] + offs
    vx = tx <= x1[..., None]
    vy = ty <= y1[..., None]
    tile = ty[..., :, None] * n_tiles_x + tx[..., None, :]   # (B, N, S, S)
    val = ok[..., None, None] & vy[..., :, None] & vx[..., None, :]
    key = torch.where(val, tile * KEYB + rank[..., None, None],
                      torch.full_like(tile, _KEY_PAD))

    L = N * max_span * max_span
    skey, order = torch.sort(key.reshape(B, L), dim=1, stable=True)
    sgid = order // (max_span * max_span)

    qs = (torch.arange(T + 1, device=dev) * KEYB).expand(B, T + 1)
    bounds = torch.searchsorted(skey, qs.contiguous())        # (B, T+1)
    starts = bounds[:, :-1]
    pos = torch.clamp(starts[:, :, None] + torch.arange(K, device=dev),
                      0, L - 1).reshape(B, T * K)
    kk = torch.gather(skey, 1, pos).reshape(B, T, K)
    ids = torch.where(
        kk // KEYB == torch.arange(T, device=dev)[None, :, None],
        torch.gather(sgid, 1, pos).reshape(B, T, K),
        torch.full_like(kk, -1))
    counts = bounds[:, 1:] - starts
    return ids.to(torch.int32), counts.to(torch.int32)


def bin_gaussians(means2d, radius, depth, visible, n_tiles_x, n_tiles_y,
                  K, max_span=4):
    """One-camera bin_gaussians_batch: means2d (N,2), radius/depth/visible
    (N,) → (tile_ids (T,K), counts (T,))."""
    ids, counts = bin_gaussians_batch(
        means2d[None], radius[None], depth[None], visible[None], n_tiles_x,
        n_tiles_y, K, max_span)
    return ids[0], counts[0]


@torch.no_grad()
def bin_batch(means3D, scales, rotations, opacities, alive, w2cs, taus,
              intrinsics, *, H, W, K, max_span=4, near=0.01, margin=0.0):
    """Standalone tile binning for a camera batch (same geometry as
    rasterize_batch), reused for several optimization iterations."""
    ntx, nty = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    means2d, depth_z, _, radius, visible = _project_cameras(
        means3D, scales, rotations, alive, w2cs, taus, intrinsics,
        H, W, near)
    return bin_gaussians_batch(
        means2d, _bin_radius(radius, opacities, margin), depth_z, visible,
        ntx, nty, K, max_span)


@torch.no_grad()
def raster_health(means3D, scales, rotations, opacities, alive, w2cs, taus,
                  intrinsics, *, H, W, K, max_span=4, near=0.01):
    """(overflow_frac, crop_frac, max_count) of the two bounded-work caps."""
    ntx, nty = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    means2d, depth_z, _, radius, visible = _project_cameras(
        means3D, scales, rotations, alive, w2cs, taus, intrinsics,
        H, W, near)
    r = _bin_radius(radius, opacities)
    _, counts = bin_gaussians_batch(
        means2d, r, depth_z, visible, ntx, nty, K, max_span)
    counts = counts.to(torch.int64)
    total = torch.clamp(counts.sum(), min=1)
    overflow = torch.clamp(counts - K, min=0).sum() / total
    u, v = means2d[..., 0], means2d[..., 1]
    fl = lambda a, hi: torch.clamp(torch.floor(a / TILE), 0, hi - 1)
    x0, x1 = fl(u - r, ntx), fl(u + r, ntx)
    y0, y1 = fl(v - r, nty), fl(v + r, nty)
    binned = visible & (r > 0)
    big = binned & ((x1 - x0 + 1 > max_span) | (y1 - y0 + 1 > max_span))
    crop = big.sum() / torch.clamp(binned.sum(), min=1)
    return overflow, crop, counts.max()


# ---------------------------------------------------------------------------
# compositing: plain versions of B1/B2 and the autograd Function
# ---------------------------------------------------------------------------

def _tile_pixels(T, ntx, device):
    """Pixel centres of every tile: x, y (T, 256) f32."""
    t = torch.arange(T, device=device)[:, None]
    p = torch.arange(NPIX, device=device)[None, :]
    px = ((t % ntx) * TILE + p % TILE).to(torch.float32)
    py = ((t // ntx) * TILE + p // TILE).to(torch.float32)
    return px, py


def _gather_tiles(packets, tile_ids, counts):
    """Global ids (B·T, K) into the flattened packets (B·N + 1 rows, the
    last a zero row for padding) and the per-entry live mask."""
    B, N, _ = packets.shape
    _, T, K = tile_ids.shape
    ids = tile_ids.to(torch.int64)
    in_count = torch.arange(K, device=ids.device) < \
        torch.clamp(counts.to(torch.int64), max=K)[..., None]
    valid = (ids >= 0) & in_count
    cam = (torch.arange(B, device=ids.device) * N)[:, None, None]
    gid = torch.where(valid, ids + cam, torch.full_like(ids, B * N))
    flat = torch.cat([packets.reshape(B * N, 10),
                      packets.new_zeros(1, 10)], 0)
    return flat, gid.reshape(B * T, K), valid.reshape(B * T, K)


def _contributor(pk, valid_k, px, py):
    """Per-pixel evaluation of one contributor for every tile: pk (BT,10),
    valid_k (BT,) → dx, dy, power, alpha_raw, alpha (gated), live."""
    f = lambda i: pk[:, i, None]
    dx = px - f(0)
    dy = py - f(1)
    power = -0.5 * (f(2) * dx * dx + f(4) * dy * dy) - f(3) * dx * dy
    alpha_raw = f(8) * torch.exp(power)
    alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
    live = (power <= 0) & (alpha >= ALPHA_MIN) & valid_k[:, None]
    return dx, dy, power, alpha_raw, torch.where(live, alpha, 0.0), live


def composite_fwd_torch(packets, tile_ids, counts, ntx, want_touched=True):
    """Plain PyTorch B1: the kernel's arithmetic, contributor by contributor
    (sequential transmittance), vectorised over tiles and pixels. Same
    signature and outputs as raster_cuda.composite_fwd."""
    plain_calls["composite_fwd"] += 1
    B, N, _ = packets.shape
    _, T, K = tile_ids.shape
    flat, gid, valid = _gather_tiles(packets, tile_ids, counts)
    px, py = _tile_pixels(T, ntx, packets.device)
    px, py = px.repeat(B, 1), py.repeat(B, 1)
    BT = B * T
    tr = packets.new_ones(BT, NPIX)
    acc = [packets.new_zeros(BT, NPIX) for _ in range(4)]
    touched = torch.zeros(BT, K, dtype=torch.int32, device=packets.device)
    for k in range(K):
        pk = flat[gid[:, k]]
        _, _, _, _, alpha, _ = _contributor(pk, valid[:, k], px, py)
        test = tr * (1.0 - alpha)
        w = torch.where(test < T_MIN, 0.0, alpha * tr)
        for c, field in enumerate((5, 6, 7, 9)):
            acc[c] = acc[c] + w * pk[:, field, None]
        tr = test
        touched[:, k] = (w > 0).sum(1)
    out = torch.stack(acc + [1.0 - tr], 1).reshape(B, T, 5, NPIX)
    ntouch = torch.zeros(B * N + 1, dtype=torch.int32, device=packets.device)
    if want_touched:
        ntouch.index_add_(0, gid.reshape(-1), touched.reshape(-1))
    return out, ntouch[:-1].reshape(B, N)


def composite_bwd_torch(packets, tile_ids, counts, ntx, gout, fwdout):
    """Plain PyTorch B2: front-to-back suffix-sum backward
    dL/dαᵢ = T_beforeᵢ·sᵢ + (g_A·T_final − Σ_{j>i} wⱼsⱼ)/(1−αᵢ), with
    T_final and Σwᵢsᵢ from the forward's output. Returns (B, N, 10)."""
    plain_calls["composite_bwd"] += 1
    B, N, _ = packets.shape
    _, T, K = tile_ids.shape
    flat, gid, valid = _gather_tiles(packets, tile_ids, counts)
    px, py = _tile_pixels(T, ntx, packets.device)
    px, py = px.repeat(B, 1), py.repeat(B, 1)
    BT = B * T
    go = gout.reshape(BT, 5, NPIX)
    fo = fwdout.reshape(BT, 5, NPIX)
    gc0, gc1, gc2, gd, ga = go.unbind(1)
    G = ga * (1.0 - fo[:, 4])
    s_tot = fo[:, 0] * gc0 + fo[:, 1] * gc1 + fo[:, 2] * gc2 + fo[:, 3] * gd
    tr = packets.new_ones(BT, NPIX)
    pre = packets.new_zeros(BT, NPIX)
    grad = packets.new_zeros(B * N + 1, 10)
    for k in range(K):
        pk = flat[gid[:, k]]
        dx, dy, power, alpha_raw, alpha, live = _contributor(
            pk, valid[:, k], px, py)
        f = lambda i: pk[:, i, None]
        test = tr * (1.0 - alpha)
        wl = test >= T_MIN
        w = torch.where(wl, alpha * tr, 0.0)
        s = f(5) * gc0 + f(6) * gc1 + f(7) * gc2 + f(9) * gd
        pre = pre + w * s
        s_after = s_tot - pre
        galpha = torch.where(wl & live, tr * s, 0.0) \
            + torch.where(live, (G - s_after) / (1.0 - alpha), 0.0)
        unc = live & (alpha_raw < MAX_ALPHA)
        g_pow = torch.where(unc, galpha * alpha_raw, 0.0)
        g_opa = torch.where(unc, galpha * torch.exp(power), 0.0)
        rows = torch.stack([
            g_pow * (f(2) * dx + f(3) * dy),
            g_pow * (f(4) * dy + f(3) * dx),
            g_pow * (-0.5 * dx * dx),
            g_pow * (-dx * dy),
            g_pow * (-0.5 * dy * dy),
            w * gc0, w * gc1, w * gc2, g_opa, w * gd], -1).sum(1)
        grad.index_add_(0, gid[:, k], rows)
        tr = test
    return grad[:-1].reshape(B, N, 10)


class _Composite(torch.autograd.Function):
    """Compositing over per-tile contributor lists; differentiable in the
    packets. Forward = B1, backward = B2 (or their plain versions on the
    CPU, by raster_cuda's dispatch)."""

    @staticmethod
    def forward(ctx, packets, tile_ids, counts, ntx, want_touched):
        out, ntouch = raster_cuda.composite_fwd(packets, tile_ids, counts,
                                                ntx, want_touched)
        ctx.save_for_backward(packets, tile_ids, counts, out)
        ctx.ntx = ntx
        ctx.mark_non_differentiable(ntouch)
        return out, ntouch

    @staticmethod
    def backward(ctx, g_out, _g_ntouch):
        packets, tile_ids, counts, out = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        grad = raster_cuda.composite_bwd(packets, tile_ids, counts, ctx.ntx,
                                         g_out.contiguous(), out)
        return grad, None, None, None, None


@dataclasses.dataclass
class RenderOutput:
    color: torch.Tensor      # (B, H, W, 3)
    depth: torch.Tensor      # (B, H, W)
    alpha: torch.Tensor      # (B, H, W)
    radii: torch.Tensor      # (B, N)
    n_touched: torch.Tensor  # (B, N) int32
    means2d: torch.Tensor    # (B, N, 2)


def make_packets(means2d, conic, colors, opacities, depth_z):
    """The compositor's per-camera packets (B, N, 10): [mean_x, mean_y,
    conic a, b, c, r, g, b, opacity in [0, 1], depth]."""
    B, N = depth_z.shape
    return torch.cat([
        means2d, conic, colors,
        torch.clamp(opacities, 0.0, 1.0)[None, :, None].expand(B, N, 1),
        depth_z[..., None]], -1).contiguous()


def project_packets(means3D, scales, rotations, opacities, colors, alive,
                    w2cs, taus, intrinsics, means2d_dummy=None, *, H, W,
                    near=0.01):
    """rasterize_batch before the compositor: the projection, the
    screen-space dummy added to the means and the compositor's packets.
    Returns (packets (B,N,10), means2d, depth_z, radius, visible, radii
    (B,N): the binning inputs and the detached radii of the visible
    Gaussians)."""
    B = w2cs.shape[0]
    N = means3D.shape[0]
    if colors.dim() == 2:
        colors = colors[None].expand(B, N, 3)
    means2d, depth_z, conic, radius, visible = _project_cameras(
        means3D, scales, rotations, alive, w2cs, taus, intrinsics,
        H, W, near)
    if means2d_dummy is not None:
        means2d = means2d + means2d_dummy
    packets = make_packets(means2d, conic, colors, opacities, depth_z)
    radii = torch.where(visible, radius, torch.zeros_like(radius)).detach()
    return packets, means2d, depth_z, radius, visible, radii


def tiles_to_image(out, bg, *, H, W):
    """rasterize_batch after the compositor: its (B,T,5,256) tile rows as
    images. Returns (color (B,H,W,3) over the background, depth, alpha)."""
    B = out.shape[0]
    ntx, nty = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    img = out.reshape(B, nty, ntx, 5, TILE, TILE).permute(
        0, 1, 4, 2, 5, 3).reshape(B, nty * TILE, ntx * TILE, 5)[:, :H, :W]
    alpha = img[..., 4]
    color = img[..., :3] + (1.0 - alpha)[..., None] * bg
    return color, img[..., 3], alpha


def composite(packets, tile_ids, tile_counts, W, want_touched):
    """The compositor between project_packets and tiles_to_image: B1
    forward, B2 backward (their plain versions on the CPU). Returns
    (out (B,T,5,256), n_touched (B,N))."""
    ntx = (W + TILE - 1) // TILE
    return _Composite.apply(
        packets, tile_ids.to(torch.int32).contiguous(),
        tile_counts.to(torch.int32).contiguous(), ntx, want_touched)


def rasterize_batch(means3D, scales, rotations, opacities, colors, alive,
                    w2cs, taus, intrinsics, bg, means2d_dummy=None,
                    tile_ids=None, tile_counts=None, *, H, W, K=512,
                    max_span=4, near=0.01, want_touched=True):
    """Render ONE Gaussian set into a batch of cameras.

    means3D (N,3); scales (N,3); rotations (N,4) wxyz; opacities (N,);
    colors (N,3) or (B,N,3); alive (N,) bool; w2cs (B,4,4); taus (B,6)
    pose deltas (exp(tau) ∘ w2c); intrinsics (4,); bg (3,);
    means2d_dummy (B,N,2) zeros whose gradient is the screen-space
    gradient; tile_ids/tile_counts: optional prebinned lists (bin_batch).
    want_touched=False returns an all-zero n_touched. Three pieces:
    project_packets, composite, tiles_to_image.
    """
    ntx, nty = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    packets, means2d, depth_z, radius, visible, radii = project_packets(
        means3D, scales, rotations, opacities, colors, alive, w2cs, taus,
        intrinsics, means2d_dummy, H=H, W=W, near=near)
    if tile_ids is None:
        with torch.no_grad():
            tile_ids, tile_counts = bin_gaussians_batch(
                means2d, _bin_radius(radius, opacities), depth_z, visible,
                ntx, nty, K, max_span)
    out, n_touched = composite(packets, tile_ids, tile_counts, W,
                               want_touched)
    color, depth, alpha = tiles_to_image(out, bg, H=H, W=W)
    return RenderOutput(color=color, depth=depth, alpha=alpha,
                        radii=radii, n_touched=n_touched, means2d=means2d)


def rasterize(means3D, scales, rotations, opacities, colors, alive, w2c,
              tau, intrinsics, bg, means2d_dummy=None, *, H, W, K=512,
              max_span=4, near=0.01):
    """One-camera rasterize_batch: w2c (4,4), tau (6,), means2d_dummy
    (N,2); the outputs without the camera dimension. Differentiable in the
    Gaussian parameters and tau."""
    out = rasterize_batch(
        means3D, scales, rotations, opacities, colors, alive, w2c[None],
        tau[None], intrinsics, bg,
        None if means2d_dummy is None else means2d_dummy[None], H=H, W=W,
        K=K, max_span=max_span, near=near)
    return RenderOutput(**{f.name: getattr(out, f.name)[0]
                           for f in dataclasses.fields(out)})


def rasterize_reference(means3D, scales, rotations, opacities, colors,
                        alive, w2c, tau, intrinsics, bg, *, H, W,
                        near=0.01):
    """Slow exact renderer: every pixel × every Gaussian, global depth
    order, no tiling and no contributor cap. Ground truth for tests."""
    means2d, depth_z, conic, radius, in_front = project_gaussians(
        means3D, scales, rotations,
        lie.to_matrix(lie.exp(tau))[None] @ w2c[None], intrinsics, H, W,
        near)
    means2d, depth_z, conic = means2d[0], depth_z[0], conic[0]
    visible = in_front[0] & alive & (radius[0] > 0)
    order = torch.sort(torch.where(visible, depth_z,
                                   torch.full_like(depth_z, float("inf"))),
                       stable=True).indices
    m2d, con, col = means2d[order], conic[order], colors[order]
    opa = torch.clamp(opacities, 0.0, 1.0)[order]
    dep, vis = depth_z[order], visible[order]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2).to(means3D.device)
    d = pix[:, None, :] - m2d[None]
    power = -0.5 * (con[None, :, 0] * d[..., 0] ** 2
                    + con[None, :, 2] * d[..., 1] ** 2) \
        - con[None, :, 1] * d[..., 0] * d[..., 1]
    alpha = torch.clamp(opa[None] * torch.exp(power), max=MAX_ALPHA)
    alpha = torch.where((power > 0) | (alpha < ALPHA_MIN) | ~vis[None],
                        0.0, alpha)
    cum = torch.cumprod(1.0 - alpha, 1)
    T_before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], 1)
    w = torch.where(T_before * (1.0 - alpha) < T_MIN, 0.0, alpha * T_before)
    color = (w[..., None] * col[None]).sum(1)
    depth = (w * dep[None]).sum(1)
    a_acc = w.sum(1)
    color = color + (1 - a_acc)[:, None] * bg
    return (color.reshape(H, W, 3), depth.reshape(H, W), a_acc.reshape(H, W))
