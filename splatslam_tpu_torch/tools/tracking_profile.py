"""Decompose the tracking hot path into per-layer costs (the port's
counterpart of tools/tracking_profile.py: the same flags, defaults, rows
and JSON extras, plus --device).

Times, at smoke scale by default (48 edges, 1/8-res 30x40 of a 240x320
frame, 16 frames), in ms per call, with the network in its compute dtype
(bf16 unless SPLATSLAM_F32_NET is set):
  fnet / cnet   - encoders on one 240x320 frame
  alt_corr      - correlation lookup of N edges in the 4-level pyramid
  update_step   - corr/flow encoders + ConvGRU + heads (N edges)
  update_agg    - GraphAgg eta/upmask
  dba_2iter     - stage-1 DBA, 2 Gauss-Newton iterations
  upsample      - convex disparity upsampling
Every row names the function the JAX row names; none is a TPU program.
The JAX tool's note on its fused round program holds here as the timers:
`fe.rounds` in a run's phase timers is the whole round.

Weights (Flax's initialisation) and data come from seeded
torch.Generators. On the card each row is timed with CUDA events after
warm-up; `--device cpu` runs the same rows on the CPU (for the tests).

Usage: python -m splatslam_tpu_torch.tools.tracking_profile [--json]
           [--edges N] [--hw H,W] [--frames M] [--device cuda|cpu]
"""

from __future__ import annotations

import types

import torch

from .. import resolve_device
from ..models.droid_net import DroidNet, compute_dtype, normalize_images
from ..ops import ba, corr as corr_ops, projective as pops
from ..ops.upsample import upsample_disp
from ._profile import Row, device_name, emit, parser, time_rows


def build_parser():
    ap = parser(__doc__)
    ap.add_argument("--edges", type=int, default=48)
    ap.add_argument("--hw", type=str, default="240,320")
    ap.add_argument("--frames", type=int, default=16)
    return ap


@torch.no_grad()
def setup(args, device):
    """Every row's inputs, on `device`."""
    H, W = map(int, args.hw.split(","))
    h, w, N, M = H // 8, W // 8, args.edges, args.frames
    g = torch.Generator().manual_seed(0)
    dt = compute_dtype()
    s = types.SimpleNamespace(H=H, W=W, h=h, w=w, N=N, M=M, dt=dt)
    s.model = DroidNet(device=device, dtype=dt, generator=g)
    s.img = torch.rand((1, H, W, 3), generator=g).to(device)
    s.fmaps = torch.randn((M, 128, h, w), generator=g).to(device)
    s.ii = torch.randint(0, M, (N,), generator=g).to(device)
    s.jj = torch.randint(0, M, (N,), generator=g).to(device)
    s.coords = pops.coords_grid(h, w, device=device)[None].expand(
        N, h, w, 2).contiguous()
    s.pyr = corr_ops.build_fmap_pyramid(s.fmaps, 4)
    s.corr = corr_ops.alt_corr(s.pyr, s.ii, s.jj, s.coords)
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    s.net, s.inp, s.flow = z(N, 128, h, w), z(N, 128, h, w), z(N, 4, h, w)
    uniq, s.ix = torch.unique(s.ii, return_inverse=True)
    s.n_uniq = int(uniq.shape[0])
    # DBA at the same scale: identity poses, unit disparities, zero flow
    s.poses = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device=device).repeat(
        M, 1)
    s.disps = torch.ones((M, h, w), device=device)
    s.intr8 = torch.tensor([40.0, 40.0, w / 2, h / 2], device=device)
    s.target = s.coords.clone()
    s.weight = torch.ones((N, h, w, 2), device=device)
    s.edges = ba.make_edges(s.ii, s.jj, 1, M, device)
    s.eta = torch.full((s.edges.kx.shape[0], h, w), 1e-3, device=device)
    s.sens = torch.zeros_like(s.disps)
    s.upmask = torch.zeros((4, h, w, 576), device=device)
    s.d4 = torch.ones((4, h, w), device=device)
    return s


def rows(s):
    m = s.model
    return [
        Row("fnet_ms", lambda: m.features(normalize_images(s.img)), n=10),
        Row("cnet_ms", lambda: m.context(normalize_images(s.img)), n=10),
        Row("alt_corr_ms", lambda: corr_ops.alt_corr(s.pyr, s.ii, s.jj,
                                                     s.coords), n=10),
        Row("update_step_ms", lambda: m.update_step(
            s.net, s.inp, s.corr.to(s.dt), s.flow), n=10),
        Row("update_agg_ms", lambda: m.update_agg(s.net, s.ix, s.n_uniq),
            n=10),
        Row("dba_2iter_ms", lambda: ba.dba(
            s.poses, s.disps, s.intr8, s.target, s.weight, s.eta, s.sens,
            s.edges, iters=2), n=10),
        Row("upsample_ms", lambda: upsample_disp(s.d4, s.upmask), n=10),
    ]


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    s = setup(args, device)
    with torch.no_grad():
        results = time_rows(rows(s), device)
    return emit(results, dict(edges=s.N, h=s.h, w=s.w, frames=s.M,
                              device=device_name(device)), args.json, 18)


if __name__ == "__main__":
    main()
