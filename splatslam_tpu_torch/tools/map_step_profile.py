"""Decompose map_step's time into its parts (the port's counterpart of
tools/map_step_profile.py: the same flags, defaults, rows and JSON extras,
plus --device).

Times, at Replica scale by default (12 cameras, 320x640, K=256, capacity
131072 with half alive), in ms per call:
  project            - project_gaussians over the camera batch
  bin                - bin_gaussians_batch (one sort of packed keys +
                       searchsorted)
  packets            - make_packets, the (B,N,10) gather of the projection
                       outputs that B1/B2 read through the tile lists
  composite_fwd      - B1, the compositing forward kernel (with n_touched)
  composite_fwd_notouch - B1 without n_touched
  composite_bwd      - B2, the gradient accumulation kernel
  rast_fwd           - the whole rasterize_batch forward
  rast_vjp           - rasterize_batch forward + backward of a scalar loss
  map_step           - the whole training step (loss, backward, Adam)
  map_step_hot       - map_step on prebinned lists without n_touched (the
                       hot loop's configuration)
  map_step_n_periter - a 16-iteration map_step_n segment, per iteration
Rows the JAX tool names after what the TPU runs, and their counterparts:
  prep_ms (_pallas_prep, the gather into the Pallas tile-list layout)
      -> packets_ms (the CUDA kernels gather their contributors themselves)
  pallas_fwd_ms / pallas_fwd_notouch_ms / pallas_bwd_ms
      -> composite_fwd_ms / composite_fwd_notouch_ms / composite_bwd_ms,
         launched through ops/raster_cuda.py (the plain versions on the CPU)
Extras: B, H, W, K, capacity, alive, ssim, opt_poses, dense and the tile
occupancy of the cloud (tile_count_mean / tile_count_p95: how close to the
K cap the compositor runs; the default cloud is sparse, --dense near K).

The map is the JAX tool's synthetic cloud drawn from a seeded
torch.Generator. The map_step rows optimise a copy of it in place; the
copy is restored before every call, outside the timed span, so each call
starts from the same map as the JAX step does.

Usage: python -m splatslam_tpu_torch.tools.map_step_profile [--json]
           [--gaussians N] [--cams B] [--hw H,W] [--K k] [--ssim]
           [--opt-poses] [--dense] [--device cuda|cpu]
"""

from __future__ import annotations

import types

import torch

from .. import resolve_device
from ..mapping import gaussians as G
from ..mapping.mapper import map_step, map_step_n
from ..ops import raster_cuda, rasterizer as rz
from ._profile import (Row, device_name, emit, make_cloud, parser,
                       state_keeper, time_rows)

LRS = dict(xyz=1e-4, f_dc=0.0025, f_rest=1e-4, opacity=0.05,
           scaling=0.001, rotation=0.001)
CAM_LRS = (5e-4, 1.5e-3)
NIT = 16


def build_parser():
    ap = parser(__doc__)
    ap.add_argument("--gaussians", type=int, default=1 << 17)
    ap.add_argument("--cams", type=int, default=12)
    ap.add_argument("--hw", type=str, default="320,640")
    ap.add_argument("--K", type=int, default=256)
    ap.add_argument("--ssim", action="store_true",
                    help="use_ssim=True in map_step (production map() path)")
    ap.add_argument("--opt-poses", action="store_true",
                    help="opt_poses=True (tau grads + retraction)")
    ap.add_argument("--dense", action="store_true",
                    help="cluster the cloud so tiles run near K contributors "
                         "(real-scene occupancy; default cloud is sparse)")
    return ap


@torch.no_grad()
def setup(args, device, nit=NIT):
    """Every row's inputs, on `device`; the projection, binning, packets
    and B1 output the later rows start from are computed once here. `nit`
    is the map_step_n segment's length (the JAX tool's 16; the tests
    shrink it)."""
    device = resolve_device(device)     # the SSIM convolutions: no TF32
    H, W = map(int, args.hw.split(","))
    B, K, C = args.cams, args.K, args.gaussians
    s = types.SimpleNamespace(H=H, W=W, B=B, K=K, C=C, n_alive=C // 2,
                              ssim=args.ssim, opt_poses=args.opt_poses,
                              dense=args.dense, nit=nit)
    s.ntx, s.nty = (W + 15) // 16, (H + 15) // 16
    s.st = st = make_cloud(C, device, dense=args.dense)
    s.intr = torch.tensor([W * 15 / 16.0, W * 15 / 16.0, W / 2.0, H / 2.0],
                          device=device)
    s.w2cs = torch.eye(4, device=device).repeat(B, 1, 1)
    s.scal, s.opac = G.get_scaling(st), G.get_opacity(st)[:, 0]
    s.cols = G.get_colors_dc(st)
    s.means2d, s.depth_z, s.conic, s.radius, in_front = \
        rz.project_gaussians(st.xyz, s.scal, st.rotation, s.w2cs, s.intr, H,
                             W)
    s.visible = in_front & st.alive[None]
    s.tile_ids, s.tile_counts = rz.bin_gaussians_batch(
        s.means2d, s.radius, s.depth_z, s.visible, s.ntx, s.nty, K)
    s.packets = rz.make_packets(s.means2d, s.conic,
                                s.cols[None].expand(B, C, 3), s.opac,
                                s.depth_z)
    s.fout, _ = raster_cuda.composite_fwd(s.packets, s.tile_ids,
                                          s.tile_counts, s.ntx)
    s.gout = torch.full_like(s.fout, 1e-3)
    g = torch.Generator().manual_seed(1)
    s.imgs = torch.rand((B, H, W, 3), generator=g).to(device)
    s.deps = torch.full((B, H, W), 2.5, device=device)
    z = lambda *shape: torch.zeros(shape, device=device)
    s.expo, s.exp_state, s.tau_state = z(B, 2), (z(B, 2), z(B, 2)), \
        (z(B, 6), z(B, 6))
    s.ones_b = torch.ones(B, dtype=torch.bool, device=device)
    s.pose_mask = s.ones_b.clone() if args.opt_poses else ~s.ones_b
    return s


def rows(s):
    st, B, H, W, K = s.st, s.B, s.H, s.W, s.K
    cams = (s.w2cs, s.imgs, s.deps, s.expo, s.ones_b, s.ones_b, s.pose_mask,
            s.intr, LRS, CAM_LRS)
    kw = dict(H=H, W=W, K=K, use_ssim=s.ssim, alpha=0.8,
              opt_poses=s.opt_poses)
    lists = (s.packets, s.tile_ids, s.tile_counts, s.ntx)
    zeros_b6 = torch.zeros((B, 6), device=st.device)
    zeros3 = torch.zeros(3, device=st.device)

    def rast_vjp():
        leaves = [x.detach().requires_grad_(True)
                  for x in (st.xyz, s.scal, st.rotation, s.opac, s.cols)]
        with torch.enable_grad():
            out = rz.rasterize_batch(*leaves[:5], st.alive, s.w2cs,
                                     zeros_b6, s.intr, zeros3, H=H, W=W,
                                     K=K)
            return torch.autograd.grad(out.color.sum() + out.depth.sum(),
                                       leaves)

    steps = []
    for name, n, fn in (
            ("map_step_ms", 3, lambda c: map_step(
                c, s.exp_state, s.tau_state, *cams, 1, 10.0, **kw)),
            ("map_step_hot_ms", 3, lambda c: map_step(
                c, s.exp_state, s.tau_state, *cams, 1, 10.0, s.tile_ids,
                s.tile_counts, want_touched=False, **kw)),
            ("map_step_n_periter_ms", 2, lambda c: map_step_n(
                c, s.exp_state, s.tau_state, *cams, 0, s.nit, 10.0, **kw))):
        reset, copy = state_keeper(st)
        steps.append(Row(name, lambda fn=fn, copy=copy: fn(copy), n=n,
                         per=s.nit if "_n_" in name else 1, reset=reset))
    return [
        Row("project_ms", lambda: rz.project_gaussians(
            st.xyz, s.scal, st.rotation, s.w2cs, s.intr, H, W)),
        Row("bin_ms", lambda: rz.bin_gaussians_batch(
            s.means2d, s.radius, s.depth_z, s.visible, s.ntx, s.nty, K)),
        Row("packets_ms", lambda: rz.make_packets(
            s.means2d, s.conic, s.cols[None].expand(B, s.C, 3), s.opac,
            s.depth_z)),
        Row("composite_fwd_ms", lambda: raster_cuda.composite_fwd(*lists)),
        Row("composite_fwd_notouch_ms", lambda: raster_cuda.composite_fwd(
            *lists, want_touched=False)),
        Row("composite_bwd_ms", lambda: raster_cuda.composite_bwd(
            *lists, s.gout, s.fout)),
        Row("rast_fwd_ms", lambda: rz.rasterize_batch(
            st.xyz, s.scal, st.rotation, s.opac, s.cols, st.alive, s.w2cs,
            zeros_b6, s.intr, zeros3, H=H, W=W, K=K)),
        Row("rast_vjp_ms", rast_vjp),
    ] + steps


def extras(s, device):
    cnt = s.tile_counts.float()
    return dict(B=s.B, H=s.H, W=s.W, K=s.K, capacity=s.C, alive=s.n_alive,
                ssim=s.ssim, opt_poses=s.opt_poses, dense=s.dense,
                tile_count_mean=round(float(cnt.mean()), 1),
                tile_count_p95=round(float(torch.quantile(
                    cnt.reshape(-1).cpu(), 0.95)), 1),
                device=device_name(device))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    s = setup(args, device)
    results = time_rows(rows(s), device)
    return emit(results, extras(s, device), args.json, 24)


if __name__ == "__main__":
    main()
