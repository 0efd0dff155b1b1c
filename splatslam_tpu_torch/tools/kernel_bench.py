"""Per-layer timings of the hot paths at Replica-like shapes (the port's
counterpart of tools/kernel_bench.py: the same flags, defaults, rows and
JSON output, plus --device).

Times, in ms per call:
  * fnet/cnet encoders on one 320x640 frame (float32 network)
  * the update operator (reprojection, correlation lookup, ConvGRU, heads,
    GraphAgg) over 96 edges at 40x80 (compute-dtype network)
  * stage-1 DBA, 2 iterations, over the same 96 edges and a 50-frame window
  * frame_distance of the 96 edges and depth_filter of 48 frames
  * one-camera rasterize at 320x640, K=256, and one 12-camera map_step
    (L1 loss) on a map of --gaussians capacity with half alive
Rows the JAX tool names after what the TPU runs, and their counterparts:
  update_kernel_96edges_ms (factor_graph._update_kernel)
      -> update_operator_96edges_ms (tracking/factor_graph.update_operator)
The rasterizer rows launch B1/B2 through ops/raster_cuda.py on the card
(their plain versions on the CPU).

Weights (Flax's initialisation) and data come from seeded
torch.Generators; the map_step row steps a copy of the map that is
restored before every call, outside the timed span.

Usage: python -m splatslam_tpu_torch.tools.kernel_bench [--json]
           [--gaussians N] [--device cuda|cpu]
"""

from __future__ import annotations

import types

import torch

from .. import resolve_device
from ..mapping import gaussians as G
from ..mapping.mapper import map_step
from ..models.droid_net import DroidNet, compute_dtype
from ..ops import ba, lie, rasterizer as rz
from ..tracking.depth_video import depth_filter, frame_distance
from ..tracking.factor_graph import update_operator
from ._profile import (Row, device_name, emit, make_cloud, parser,
                       state_keeper, time_rows)
from .map_step_profile import CAM_LRS, LRS


def build_parser():
    ap = parser(__doc__)
    ap.add_argument("--gaussians", type=int, default=1 << 17)
    return ap


@torch.no_grad()
def setup(args, device, H=320, W=640, P=64, N=96, window=50, n_filter=48,
          B=12):
    """Every row's inputs, on `device`. The keyword sizes are the JAX
    tool's constants (the tests shrink them): frame H x W, P keyframes at
    1/8 resolution, N edges inside the first `window` frames, depth_filter
    over `n_filter` frames, B mapping cameras."""
    g = torch.Generator().manual_seed(0)
    h, w = H // 8, W // 8
    s = types.SimpleNamespace(H=H, W=W, h=h, w=w, N=N, B=B, window=window,
                              n_filter=n_filter)
    # one set of weights in two dtypes: the JAX tool's encoders run the
    # float32 DroidNet(), its update kernel the compute dtype
    s.model32 = DroidNet(device=device, generator=g)
    s.model = DroidNet(device=device, dtype=compute_dtype())
    s.model.load_state_dict(s.model32.state_dict())
    s.img = torch.rand((1, 3, H, W), generator=g).to(device)
    rn = lambda *shape: torch.randn(shape, generator=g)
    s.poses = lie.exp(rn(P, 6) * 0.05).to(device)
    s.disps = (0.5 + 0.1 * torch.rand((P, h, w), generator=g)).to(device)
    s.intr8 = torch.tensor([75.0, 75.0, 40.0, 30.0], device=device)
    s.fmaps = (rn(P, 128, h, w) * 0.1).to(device, torch.bfloat16)
    s.inps = (rn(P, 128, h, w) * 0.1).to(device)
    ii = torch.randint(0, window, (N,), generator=g)
    jj = torch.clamp(ii + torch.randint(1, 6, (N,), generator=g), 0,
                     window - 1)
    s.ii, s.jj = ii.to(device), jj.to(device)
    s.net = torch.zeros((N, 128, h, w), device=device)
    s.target = torch.zeros((N, h, w, 2), device=device)
    s.edges = ba.make_edges(s.ii, s.jj, 1, window, device)
    s.eta = torch.full((s.edges.kx.shape[0], h, w), 1e-4, device=device)
    s.target_r = (torch.rand((N, h, w, 2), generator=g) * 10).to(device)
    s.weight = torch.ones((N, h, w, 2), device=device)
    s.filter_idx = torch.arange(n_filter, device=device)
    s.filter_thresh = torch.full((n_filter,), 0.01, device=device)

    # mapping at Replica scale
    s.st = make_cloud(args.gaussians, device)
    s.n_alive = args.gaussians // 2
    s.intr = torch.tensor([W * 15 / 16.0, W * 15 / 16.0, W / 2.0, H / 2.0],
                          device=device)
    s.w2cs = torch.eye(4, device=device).repeat(B, 1, 1)
    s.imgs = torch.rand((B, H, W, 3), generator=g).to(device)
    s.deps = torch.full((B, H, W), 2.5, device=device)
    return s


def rows(s):
    st, dev = s.st, s.st.device
    z = lambda *shape: torch.zeros(shape, device=dev)
    eye = torch.eye(4, device=dev)
    ones_b = torch.ones(s.B, dtype=torch.bool, device=dev)
    reset, copy = state_keeper(st)
    return [
        Row(f"fnet_{s.H}x{s.W}_ms", lambda: s.model32.features(s.img)),
        Row(f"cnet_{s.H}x{s.W}_ms", lambda: s.model32.context(s.img)),
        Row(f"update_operator_{s.N}edges_ms", lambda: update_operator(
            s.model, s.poses, s.disps, s.intr8, s.fmaps, s.inps, s.net,
            s.target, s.ii, s.jj)),
        Row(f"dba_{s.N}edges_2iter_ms", lambda: ba.dba(
            s.poses, s.disps, s.intr8, s.target_r, s.weight, s.eta,
            torch.zeros_like(s.disps), s.edges, iters=2)),
        Row(f"frame_distance_{s.N}_ms", lambda: frame_distance(
            s.poses, s.disps, s.intr8, s.ii, s.jj, 0.6)),
        Row(f"depth_filter_{s.n_filter}_ms", lambda: depth_filter(
            s.poses, s.disps, s.intr8, s.filter_idx, s.filter_thresh)),
        Row(f"rasterize_fwd_{s.n_alive}g_ms", lambda: rz.rasterize(
            st.xyz, G.get_scaling(st), st.rotation, G.get_opacity(st)[:, 0],
            G.get_colors_dc(st), st.alive, eye, z(6), s.intr, z(3), H=s.H,
            W=s.W, K=256)),
        Row(f"map_step_{s.B}cam_{s.n_alive}g_ms", lambda: map_step(
            copy, (z(s.B, 2), z(s.B, 2)), (z(s.B, 6), z(s.B, 6)), s.w2cs,
            s.imgs, s.deps, z(s.B, 2), ones_b, ones_b, ~ones_b, s.intr,
            LRS, CAM_LRS, 1, 10.0, H=s.H, W=s.W, K=256, use_ssim=False,
            alpha=0.8), n=3, reset=reset),
    ]


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    results = time_rows(rows(setup(args, device)), device)
    return emit(results, dict(device=device_name(device)), args.json, 42)


if __name__ == "__main__":
    main()
