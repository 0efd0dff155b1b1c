"""Mapper: deformable 3D Gaussian Splatting over tracker keyframes
(counterpart of splatslam_tpu/mapping/mapper.py; reference
src/mapper.py:43-1116).

Same control flow as the JAX package — proxy-depth fusion, covisibility
keyframe window, map deformation after pose/depth updates, windowed
optimisation with densify/prune, final refinement — and the same
densify/prune/reset cadence. `map_step` renders every window camera in one
batched rasterize_batch call (the compositor is the CUDA kernel pair on
the GPU), backpropagates once and steps Adam in place; `map_step_n` is the
Python loop over iterations with the tile-binning cadence of the JAX
map_step_n. On one CUDA device, every iteration of a segment but its last
replays CUDA graphs captured once per shape (_SplitStep), with B1 and B2
launched eagerly between them; the last iteration, per-step cameras,
several devices and the CPU run `_step_shards` as it is.

With `mapping.mesh_devices: n` (and n devices visible) the camera rows of
every segment are split over n devices, the counterpart of the JAX
mapper's "cam" mesh in one process: each device bins, renders and
differentiates its rows against its replica of the map, the gradients are
summed onto the first device, and Adam steps the map there once.
"""

from __future__ import annotations

import dataclasses
import math
import os
import types

import numpy as np
import torch

from .. import resolve_device
from ..ops import lie, rasterizer as rz, sh as sh_ops
from ..tracking.depth_video import nanmedian
from . import gaussians as G
from . import fusion
from .camera import Camera, make_camera
from .losses import mapping_loss, get_median_depth
from ..utils.profiling import PhaseTimers, span, tally


ISO_WEIGHT = 10.0     # the isotropic term's weight while mapping


def _round_up(x, m):
    return max(((x + m - 1) // m) * m, m)


def _colors(st_f_dc, st_f_rest, xyz, w2cs, sh_degree):
    """Per-camera (B,N,3) SH colors or shared (N,3) degree-0 colors."""
    if sh_degree > 0:
        campos = -torch.einsum("bji,bj->bi", w2cs[:, :3, :3], w2cs[:, :3, 3])
        return torch.stack([sh_ops.sh_colors(sh_degree, st_f_dc, st_f_rest,
                                             xyz, cp) for cp in campos])
    return torch.clamp(G.sh_to_rgb(st_f_dc), min=0.0)


@torch.no_grad()
def render_eval(st, w2cs, intrinsics, *, H, W, K, sh_degree, max_span):
    """Forward-only batched render of the map (eval / gate path)."""
    B = w2cs.shape[0]
    cols = _colors(st.f_dc, st.f_rest, st.xyz, w2cs, sh_degree)
    return rz.rasterize_batch(
        st.xyz, G.get_scaling(st), st.rotation, G.get_opacity(st)[:, 0],
        cols, st.alive, w2cs, w2cs.new_zeros(B, 6), intrinsics,
        w2cs.new_zeros(3), H=H, W=W, K=K, max_span=max_span)


# ---------------------------------------------------------------------------
# the optimisation step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Cams:
    """One shard of a stacked camera batch, on its device: the rows'
    tensors, their exposure (em, ev) and pose (tm, tv) Adam moments, the
    intrinsics and, between rebins, their tile lists."""
    w2cs: torch.Tensor
    images: torch.Tensor
    depths: torch.Tensor
    exposure: torch.Tensor
    use_exposure: torch.Tensor
    cam_valid: torch.Tensor
    opt_pose_mask: torch.Tensor
    em: torch.Tensor
    ev: torch.Tensor
    tm: torch.Tensor
    tv: torch.Tensor
    intrinsics: torch.Tensor
    tile_ids: torch.Tensor | None = None
    tile_counts: torch.Tensor | None = None

    ROWS = ("w2cs", "images", "depths", "exposure", "use_exposure",
            "cam_valid", "opt_pose_mask", "em", "ev", "tm", "tv", "tile_ids",
            "tile_counts")
    STATE = ("w2cs", "exposure", "em", "ev", "tm", "tv")

    def rows(self, r):
        return dataclasses.replace(self, **{
            f: getattr(self, f)[r] for f in self.ROWS
            if getattr(self, f) is not None})

    def write_rows(self, r, other):
        for f in self.STATE:
            getattr(self, f)[r] = getattr(other, f)


def _shard_cams(devices, w2cs, images, depths, exposure, use_exposure,
                cam_valid, opt_pose_mask, exp_state, tau_state, intrinsics,
                tile_ids=None, tile_counts=None):
    """[(shard index, _Cams)] for the non-empty shards: the camera rows
    split by torch.tensor_split over `devices` (uneven shards allowed, no
    padded rows), each copied to its device. One shard, without a copy, when
    `devices` is None."""
    full = _Cams(w2cs, images, depths, exposure, use_exposure, cam_valid,
                 opt_pose_mask, exp_state[0], exp_state[1], tau_state[0],
                 tau_state[1], intrinsics, tile_ids, tile_counts)
    if devices is None:
        return [(0, full)]
    out = []
    rows = torch.tensor_split(torch.arange(w2cs.shape[0]), len(devices))
    for k, (dev, r) in enumerate(zip(devices, rows)):
        if len(r):
            part = full.rows(slice(int(r[0]), int(r[-1]) + 1))
            out.append((k, dataclasses.replace(part, **{
                f.name: getattr(part, f.name).to(dev, copy=True)
                for f in dataclasses.fields(part)
                if getattr(part, f.name) is not None})))
    return out


def _gather_cams(shards, device):
    """The shards' camera state back in row order on `device`:
    (exp_state, tau_state, w2cs, exposure)."""
    if len(shards) == 1:
        c = shards[0][1]
        return (c.em, c.ev), (c.tm, c.tv), c.w2cs, c.exposure
    cat = lambda f: torch.cat([getattr(c, f).to(device) for _, c in shards])
    return ((cat("em"), cat("ev")), (cat("tm"), cat("tv")), cat("w2cs"),
            cat("exposure"))


def _replicas(st, devices):
    """The map's replicas for shards 1..n-1: detached clones of its
    parameters and alive mask, one per shard (a repeated device gets a copy
    of its own too), refreshed from the map after each Adam step."""
    if devices is None:
        return []
    names = G.PARAM_NAMES + ("alive",)
    return [types.SimpleNamespace(**{
        n: getattr(st, n).detach().to(dev, copy=True) for n in names})
        for dev in devices[1:]]


def _iso_loss(scal, alive, weight):
    """The weighted isotropic-scale term."""
    iso = (scal - scal.mean(-1, keepdim=True)).abs()
    iso = torch.where(alive[:, None], iso, torch.zeros_like(iso))
    return weight * iso.sum() / torch.clamp(3 * alive.sum(), min=1)


def _activations(params, w2cs, sh_degree):
    """(opacity (N,), scale (N,3), colours) of the parameters."""
    opac = torch.sigmoid(params["opacity"])[:, 0]
    scal = torch.exp(params["scaling"])
    cols = _colors(params["f_dc"], params["f_rest"], params["xyz"], w2cs,
                   sh_degree)
    return opac, scal, cols


def _shard_loss(color, depth, exposure, c, scal, alive, iso_weight, *,
                alpha, use_ssim):
    """A shard's loss: its exposure-corrected render against its frames
    over the valid cameras, plus, given `scal`, the isotropic term."""
    ue = c.use_exposure[:, None, None, None]
    image_ab = torch.where(
        ue, torch.exp(exposure[:, 0, None, None, None]) * color
        + exposure[:, 1, None, None, None], color)
    per_cam = mapping_loss(image_ab, depth, c.images, c.depths, alpha=alpha,
                           use_ssim=use_ssim)
    total = torch.where(c.cam_valid, per_cam,
                        torch.zeros_like(per_cam)).sum()
    if scal is not None:
        total = total + _iso_loss(scal, alive, iso_weight)
    return total


def _densify_stats(radii, g_dummy, cam_valid):
    """The radii (B,C) of the valid cameras and, over the cameras that see
    each Gaussian, the sum of its screen-space gradient norms, their count
    and its largest radius (mapper.py:522-529)."""
    radii = radii * cam_valid[:, None]
    vis_any = radii > 0
    gn = (torch.linalg.norm(g_dummy, dim=-1) * vis_any).sum(0)
    vs = vis_any.sum(0).float()
    mr = (radii * vis_any).max(0).values
    return radii, gn, vs, mr


def _cam_adam(c, exposure, g_expo, g_tau, bc1, bc2, lr_vec):
    """A shard's exposure Adam rows and, given the pose gradient `g_tau`,
    its pose rows retracted into w2cs (monogs update_pose): the new values
    of _Cams.STATE's fields by name. bc1/bc2 are the bias corrections as
    G.unbias takes them, lr_vec the pose learning rates (6,)."""
    ge = g_expo * (c.use_exposure & c.cam_valid)[:, None]
    em = 0.9 * c.em + 0.1 * ge
    ev = 0.999 * c.ev + 0.001 * ge * ge
    new = dict(em=em, ev=ev, exposure=exposure.detach() - 0.01 * (
        G.unbias(em, bc1)) / (torch.sqrt(G.unbias(ev, bc2)) + 1e-8))
    if g_tau is not None:
        pm = (c.opt_pose_mask & c.cam_valid)[:, None]
        gt_ = g_tau * pm
        tm = 0.9 * c.tm + 0.1 * gt_
        tv = 0.999 * c.tv + 0.001 * gt_ * gt_
        upd = lr_vec * G.unbias(tm, bc1) / (
            torch.sqrt(G.unbias(tv, bc2)) + 1e-8)
        new_tau = torch.where(pm, -upd, torch.zeros_like(upd))
        dT = lie.to_matrix(lie.exp(new_tau))
        new.update(tm=tm, tv=tv, w2cs=torch.where(pm[:, :, None],
                                                  dT @ c.w2cs, c.w2cs))
    return new


def _lr_row(cam_lrs):
    """The pose learning rates (translation ×3, rotation ×3)."""
    return [cam_lrs[0]] * 3 + [cam_lrs[1]] * 3


def _step_shards(st, reps, shards, lrs, cam_lrs, step, iso_weight, *, H, W,
                 K, use_ssim, alpha, opt_poses, sh_degree, want_touched,
                 max_span):
    """One mapping iteration over camera shards. Each shard renders its
    rows from its replica of the map (shard 0 from the map itself) and
    differentiates its own loss on its device; the isotropic term is added
    once, on the first device. Gradients are summed onto the map's device,
    the densification statistics are combined there (sums, a max, radii
    and n_touched in row order), Adam steps the map once and the replicas
    are refreshed. Each shard's exposure and pose Adam rows are updated on
    its device, in place in its _Cams. Returns (radii (B,C), n_touched
    (B,C), loss) on the map's device. Traced as the span `map.iter`, each
    shard's render and loss as `map.fwd`, its gradient as `map.bwd`, the
    statistics and Adam steps as one `map.adam`."""
    with span("map.iter"):
        dev0, C = st.device, st.capacity
        bc1, bc2 = G.bias_corrections(step)
        g_sum, loss, radii_l, nt_l = None, None, [], []
        vis_sum = gnorm_sum = max_r = None
        if not any(k == 0 for k, _ in shards):
            # the isotropic term rides with shard 0; here it has no rows
            s = st.scaling.detach().requires_grad_(True)
            iso = _iso_loss(torch.exp(s), st.alive, iso_weight)
            g_sum = {n: torch.zeros_like(getattr(st, n))
                     for n in G.PARAM_NAMES}
            g_sum["scaling"] = torch.autograd.grad(iso, s)[0]
            loss = iso.detach()
        rendered = []
        for k, c in shards:
            src = st if k == 0 else reps[k - 1]
            dev = src.xyz.device
            with span("map.fwd"):
                B = c.w2cs.shape[0]
                params = {n: getattr(src, n).detach().requires_grad_(True)
                          for n in G.PARAM_NAMES}
                exposure = c.exposure.detach().requires_grad_(True)
                taus = torch.zeros((B, 6), device=dev, requires_grad=opt_poses)
                dummy = torch.zeros((B, C, 2), device=dev, requires_grad=True)

                opac, scal, cols = _activations(params, c.w2cs, sh_degree)
                out = rz.rasterize_batch(
                    params["xyz"], scal, params["rotation"], opac, cols,
                    src.alive, c.w2cs, taus, c.intrinsics,
                    torch.zeros(3, device=dev), means2d_dummy=dummy,
                    tile_ids=c.tile_ids, tile_counts=c.tile_counts, H=H, W=W,
                    K=K, want_touched=want_touched, max_span=max_span)
                total = _shard_loss(out.color, out.depth, exposure, c,
                                    scal if k == 0 else None, src.alive,
                                    iso_weight, alpha=alpha,
                                    use_ssim=use_ssim)

            with span("map.bwd"):
                leaves = [params[n] for n in G.PARAM_NAMES] + [exposure, dummy]
                if opt_poses:
                    leaves.append(taus)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
                grads = [torch.zeros_like(x) if g is None else g
                         for x, g in zip(leaves, grads)]
            rendered.append((c, dev, out, total, exposure, grads))

        P = len(G.PARAM_NAMES)
        with span("map.adam"), torch.no_grad():
            for c, dev, out, total, exposure, grads in rendered:
                g_expo, g_dummy = grads[P:P + 2]
                g_p = dict(zip(G.PARAM_NAMES, grads[:P]))
                if g_sum is None:
                    g_sum = g_p
                else:
                    g_sum = {n: g_sum[n] + g_p[n].to(dev0) for n in g_sum}
                loss = total.detach().to(dev0) if loss is None \
                    else loss + total.detach().to(dev0)
                radii, gn, vs, mr = _densify_stats(out.radii, g_dummy,
                                                   c.cam_valid)
                radii_l.append(radii.to(dev0))
                nt_l.append((out.n_touched * c.cam_valid[:, None]).to(dev0))
                gnorm_sum = gn.to(dev0) if gnorm_sum is None \
                    else gnorm_sum + gn.to(dev0)
                vis_sum = vs.to(dev0) if vis_sum is None \
                    else vis_sum + vs.to(dev0)
                max_r = mr.to(dev0) if max_r is None \
                    else torch.maximum(max_r, mr.to(dev0))
                lr_vec = torch.tensor(_lr_row(cam_lrs), device=dev) \
                    if opt_poses else None
                for f, v in _cam_adam(c, exposure, g_expo,
                                      grads[-1] if opt_poses else None,
                                      bc1, bc2, lr_vec).items():
                    setattr(c, f, v)

            st.grad_accum += gnorm_sum
            st.denom += vis_sum
            st.max_radii2D = torch.maximum(st.max_radii2D, max_r)
            G.adam_step(st, g_sum, lrs, step)
            for rep in reps:
                for n in G.PARAM_NAMES:
                    getattr(rep, n).copy_(getattr(st, n), non_blocking=True)
        cat = lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs)
        return cat(radii_l), cat(nt_l), loss


def map_step(st: G.GaussianState, exp_state, tau_state, w2cs, images,
             depths, exposure, use_exposure, cam_valid, opt_pose_mask,
             intrinsics, lrs, cam_lrs, step, iso_weight, tile_ids=None,
             tile_counts=None, *, H, W, K, use_ssim, alpha,
             opt_poses=False, sh_degree=0, want_touched=True, max_span=4,
             devices=None):
    """One mapping iteration over a stacked camera batch.

    st is updated IN PLACE (Adam) and returned; exp_state/tau_state are
    (m, v) Adam moments (B,2)/(B,6); w2cs (B,4,4); images (B,H,W,3);
    depths (B,H,W); exposure (B,2); use_exposure/cam_valid/opt_pose_mask
    (B,) bool; lrs per-group learning rates; cam_lrs (lr_trans, lr_rot);
    step the 1-based Adam step; iso_weight the isotropic-scale weight.
    Poses render at tau = 0 and, with opt_poses, are retracted by the
    Adam step's tau (monogs update_pose). devices: a list of devices, the
    first the map's, to split the camera rows over (the map replicated,
    gradients summed onto the first device); None renders them all on the
    map's device.

    Returns (st, exp_state, tau_state, w2cs, exposure, radii (B,C),
    n_touched (B,C), loss)."""
    shards = _shard_cams(devices, w2cs, images, depths, exposure,
                         use_exposure, cam_valid, opt_pose_mask, exp_state,
                         tau_state, intrinsics, tile_ids, tile_counts)
    radii, n_touched, loss = _step_shards(
        st, _replicas(st, devices), shards, lrs, cam_lrs, step, iso_weight,
        H=H, W=W, K=K, use_ssim=use_ssim, alpha=alpha, opt_poses=opt_poses,
        sh_degree=sh_degree, want_touched=want_touched, max_span=max_span)
    exp_state, tau_state, w2cs, exposure = _gather_cams(shards, st.device)
    return (st, exp_state, tau_state, w2cs, exposure, radii, n_touched,
            loss)


def _rebin(st, w2cs, intrinsics, *, H, W, K, margin, rebin_every, max_span):
    """Tile lists reused for several iterations: with a margin, binned at
    the opacity a reset-free logit could reach by the next rebin. `st` is
    the map or one of its replicas."""
    logit = st.opacity[:, 0]
    if margin > 0:
        logit = logit + rebin_every * 0.05
    return rz.bin_batch(st.xyz, torch.exp(st.scaling), st.rotation,
                        torch.sigmoid(logit), st.alive, w2cs,
                        w2cs.new_zeros(w2cs.shape[0], 6), intrinsics, H=H,
                        W=W, K=K, margin=margin, max_span=max_span)


# ---------------------------------------------------------------------------
# the iteration split at the compositor, replayed from CUDA graphs
# ---------------------------------------------------------------------------

# the map's fields a split iteration reads (_MAP_IN) and writes (_MAP_OUT)
_MAP_OUT = G.PARAM_NAMES + tuple(
    p + n for n in G.PARAM_NAMES for p in ("m_", "v_")) + (
    "grad_accum", "denom", "max_radii2D")
_MAP_IN = _MAP_OUT + ("alive",)
_CAM_IN = ("w2cs", "images", "depths", "exposure", "use_exposure",
           "cam_valid", "opt_pose_mask", "em", "ev", "tm", "tv",
           "intrinsics")
# a split iteration's step-dependent scalars: the learning rates by
# G.PARAM_NAMES, the two bias corrections (G.graph_factor), the pose
# learning rates
_N_LR = len(G.PARAM_NAMES)
_N_SCALARS = _N_LR + 2 + 6

_SPLITS = {}      # _SplitStep by key (_split_key)
_MAPS = {}        # the map's buffers by (device, capacity, SH rows)
_POOLS = {}       # one graph memory pool per device


def _split_scalars(lrs_at, cam_lrs, step0, n):
    """(n, _N_SCALARS) float32 rows of the step-dependent scalars of the
    iterations at steps step0 .. step0 + n - 1 (Adam steps one later),
    computed on the host as _step_shards computes them."""
    rows = []
    for i in range(n):
        lrs = lrs_at(step0 + i)
        rows.append([lrs[p] for p in G.PARAM_NAMES]
                    + [G.graph_factor(bc)
                       for bc in G.bias_corrections(step0 + i + 1)]
                    + _lr_row(cam_lrs))
    return torch.tensor(rows, dtype=torch.float32)


def _split_key(st, B, *, H, W, use_ssim, alpha, opt_poses, sh_degree,
              iso_weight):
    """What a split iteration's pieces are built for: a capture serves
    every segment with the same key."""
    return (str(_indexed(st.device)), B, st.capacity, st.f_rest.shape[1], H,
            W, bool(use_ssim), float(alpha), bool(opt_poses), sh_degree,
            float(iso_weight))


class _SplitStep:
    """One mapping iteration of one shard as three pieces around the
    compositor: A, the parameters to the packets (activations, colours,
    projection); B, the composite to the loss (exposure, mapping_loss, the
    isotropic term, the cam_valid mask); C, the densification statistics,
    the exposure and pose Adam rows and G.adam_update. The same arithmetic
    as _step_shards, over state at fixed addresses: the map's buffers
    (`s`, shared by the keys of one capacity), the cameras' (`cam`) and the
    step-dependent scalars (`sc`), read from device memory; `load` copies a
    segment's state in, `store` back out. A graph keeps no tensor alive,
    so every tensor the pieces read lives in `s`, `cam` or `sc`.

    On a CUDA device A and B replay CUDA graphs through autograd
    (torch.cuda.make_graphed_callables: a forward and a backward graph
    each), the compositor stays eager between them (B1, B2 through
    ops/raster_cuda), and C replays one more graph over the gradients and
    radii copied into its input buffers (`c_in`). Elsewhere the pieces run
    as plain functions."""

    def __init__(self, st, B, *, H, W, use_ssim, alpha, opt_poses,
                 sh_degree, iso_weight):
        dev = st.device
        self.graphed = dev.type == "cuda"
        self.W, self.opt_poses = W, opt_poses
        mk = (str(_indexed(dev)), st.capacity, st.f_rest.shape[1])
        if mk not in _MAPS:
            _MAPS[mk] = G.GaussianState(**{
                f: torch.zeros_like(getattr(st, f)) for f in G.FIELDS})
            for n in G.PARAM_NAMES:
                getattr(_MAPS[mk], n).requires_grad_(True)
        s = self.s = _MAPS[mk]
        C = st.capacity
        z = lambda *shape, **kw: torch.zeros(shape, device=dev, **kw)
        cam = self.cam = types.SimpleNamespace(
            w2cs=z(B, 4, 4), images=z(B, H, W, 3), depths=z(B, H, W),
            exposure=z(B, 2, requires_grad=True),
            use_exposure=z(B, dtype=torch.bool),
            cam_valid=z(B, dtype=torch.bool),
            opt_pose_mask=z(B, dtype=torch.bool), em=z(B, 2), ev=z(B, 2),
            tm=z(B, 6), tv=z(B, 6), intrinsics=z(4), bg=z(3),
            taus=z(B, 6, requires_grad=opt_poses),
            dummy=z(B, C, 2, requires_grad=True))
        self.sc = z(_N_SCALARS)
        self.lrs = dict(zip(G.PARAM_NAMES, self.sc[:_N_LR]))
        self.bc = self.sc[_N_LR], self.sc[_N_LR + 1]
        self.lr_vec = self.sc[_N_LR + 2:]
        self.leaves = [getattr(s, n) for n in G.PARAM_NAMES] + [
            cam.exposure, cam.dummy] + ([cam.taus] if opt_poses else [])

        def piece_a(xyz, f_dc, f_rest, opacity, scaling, rotation, dummy,
                    *taus):
            params = dict(zip(G.PARAM_NAMES, (xyz, f_dc, f_rest, opacity,
                                              scaling, rotation)))
            opac, scal, cols = _activations(params, cam.w2cs, sh_degree)
            packets, *_, radii = rz.project_packets(
                xyz, scal, rotation, opac, cols, s.alive, cam.w2cs,
                taus[0] if taus else cam.taus, cam.intrinsics, dummy, H=H,
                W=W)
            return packets, radii, scal

        def piece_b(out, exposure, scal):
            color, depth, _ = rz.tiles_to_image(out, cam.bg, H=H, W=W)
            return _shard_loss(color, depth, exposure, cam, scal, s.alive,
                               iso_weight, alpha=alpha, use_ssim=use_ssim)

        self.a_args = tuple(self.leaves[:_N_LR]) + (cam.dummy,) + (
            (cam.taus,) if opt_poses else ())
        if not self.graphed:
            self.piece_a, self.piece_b = piece_a, piece_b
            return
        T = ((W + rz.TILE - 1) // rz.TILE) * ((H + rz.TILE - 1) // rz.TILE)
        b_args = (z(B, T, 5, rz.NPIX, requires_grad=True), cam.exposure,
                  z(C, 3, requires_grad=True))
        # C's inputs: the gradients by leaf, then the radii
        self.c_in = [torch.zeros_like(x) for x in self.leaves] + [z(B, C)]
        pool = _POOLS.setdefault(str(_indexed(dev)),
                                 torch.cuda.graph_pool_handle())
        with span("map.capture"), torch.cuda.device(dev):
            self.piece_a, self.piece_b = torch.cuda.make_graphed_callables(
                (piece_a, piece_b), (self.a_args, b_args),
                allow_unused_input=True, pool=pool)
            self.c_graph = self._capture_c(pool)
        tally("n.map.capture", 1)

    @torch.no_grad()
    def load(self, st, c, scalars):
        """A segment's start: the map's and the cameras' state in, and the
        (n, _N_SCALARS) rows of its iterations' scalars."""
        for f in _MAP_IN:
            getattr(self.s, f).copy_(getattr(st, f))
        for f in _CAM_IN:
            getattr(self.cam, f).copy_(getattr(c, f))
        if self.graphed:
            scalars = scalars.pin_memory()
        self.rows = scalars.to(self.sc.device, non_blocking=True)

    @torch.no_grad()
    def store(self, st, c):
        """A segment's end: the map's state back into `st`'s tensors, the
        cameras' into new tensors of `c`."""
        for f in _MAP_OUT:
            getattr(st, f).copy_(getattr(self.s, f))
        for f in _Cams.STATE:
            setattr(c, f, getattr(self.cam, f).detach().clone())

    @torch.no_grad()
    def _piece_c(self, s, cam, grads, radii):
        P = _N_LR
        _, gn, vs, mr = _densify_stats(radii, grads[P + 1], cam.cam_valid)
        s.grad_accum += gn
        s.denom += vs
        torch.maximum(s.max_radii2D, mr, out=s.max_radii2D)
        for f, v in _cam_adam(cam, cam.exposure, grads[P],
                              grads[P + 2] if self.opt_poses else None,
                              *self.bc, self.lr_vec).items():
            getattr(cam, f).copy_(v)
        G.adam_update(s, dict(zip(G.PARAM_NAMES, grads[:P])), self.lrs,
                      *self.bc)

    def _capture_c(self, pool):
        """C's graph over `c_in`, warmed up on copies of the state."""
        copy = lambda ns, names: types.SimpleNamespace(**{
            n: getattr(ns, n).detach().clone() for n in names})
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._piece_c(copy(self.s, _MAP_IN), copy(self.cam, _CAM_IN),
                          self.c_in[:-1], self.c_in[-1])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            self._piece_c(self.s, self.cam, self.c_in[:-1], self.c_in[-1])
        return graph

    def iterate(self, i, tile_ids, tile_counts):
        """The segment's iteration `i` on prebinned tile lists, traced as
        _step_shards is; a replayed one counts under `n.map.graphed`."""
        with span("map.iter"):
            with span("map.fwd"):
                packets, radii, scal = self.piece_a(*self.a_args)
                out, _ = rz.composite(packets, tile_ids, tile_counts,
                                      self.W, False)
                total = self.piece_b(out, self.cam.exposure, scal)
            with span("map.bwd"):
                grads = torch.autograd.grad(total, self.leaves,
                                            allow_unused=True)
            with span("map.adam"), torch.no_grad():
                self.sc.copy_(self.rows[i])
                if not self.graphed:
                    self._piece_c(self.s, self.cam, [
                        torch.zeros_like(x) if g is None else g
                        for x, g in zip(self.leaves, grads)], radii)
                    return
                # an unused leaf's gradient (None) stays C's zeros
                for x, g in zip(self.c_in, grads + (radii,)):
                    if g is not None:
                        x.copy_(g)
                self.c_graph.replay()
        tally("n.map.graphed", 1)


def _split_step(st, B, **kw):
    """The cached _SplitStep of this key, built (and captured) at its
    first use."""
    key = _split_key(st, B, **kw)
    if key not in _SPLITS:
        _SPLITS[key] = _SplitStep(st, B, **kw)
    return _SPLITS[key]


def map_step_n(st, exp_state, tau_state, w2cs, images, depths, exposure,
               use_exposure, cam_valid, opt_pose_mask, intrinsics,
               lr_scalars, cam_lrs, step0, n_iters, iso_weight, *, H, W, K,
               use_ssim, alpha, lr_sched=None, opt_poses=False, sh_degree=0,
               rebin_every=8, rebin_margin=4.0, max_span=4,
               per_step_cams=False, devices=None):
    """`n_iters` mapping iterations (the JAX map_step_n schedule).

    Tile binning runs every `rebin_every` iterations with a
    `rebin_margin`-pixel footprint margin; the n_touched accumulation is
    skipped in the loop, and the last iteration bins afresh with
    want_touched=True. per_step_cams: iteration i trains on camera row i
    alone (final_refine's one-random-frame-per-step schedule), each step
    binning its own camera exactly. devices: as in map_step; the rows are
    split once for the whole segment, each shard bins its own cameras on
    its device, and a per-step row trains where its shard lives. With
    `devices` None on a CUDA device, the iterations before the last replay
    _SplitStep's CUDA graphs (the same arithmetic); the last one is always
    `_step_shards`."""
    kw = dict(H=H, W=W, K=K, use_ssim=use_ssim, alpha=alpha,
              opt_poses=opt_poses, sh_degree=sh_degree, max_span=max_span)
    bin_kw = dict(H=H, W=W, K=K, rebin_every=rebin_every, max_span=max_span)
    shards = _shard_cams(devices, w2cs, images, depths, exposure,
                         use_exposure, cam_valid, opt_pose_mask, exp_state,
                         tau_state, intrinsics)
    reps = _replicas(st, devices)
    src = lambda k: st if k == 0 else reps[k - 1]

    def lrs_at(step):
        xyz = G.xyz_lr(step, *lr_sched) if lr_sched is not None \
            else lr_scalars["xyz"]
        return dict(lr_scalars, xyz=xyz)

    if per_step_cams:
        if devices is None:
            # rows are written back in place: leave the caller's alone
            c = shards[0][1]
            for f in _Cams.STATE:
                setattr(c, f, getattr(c, f).clone())
        rows = [(k, c, i) for k, c in shards for i in range(len(c.w2cs))]
        for i in range(n_iters):
            k, c, r = rows[i]
            one = c.rows(slice(r, r + 1))
            with span("map.bin"):
                one.tile_ids, one.tile_counts = _rebin(
                    src(k), one.w2cs, one.intrinsics, margin=0.0, **bin_kw)
            step = step0 + i
            radii, n_touched, loss = _step_shards(
                st, reps, [(k, one)], lrs_at(step), cam_lrs, step + 1,
                iso_weight, want_touched=(i == n_iters - 1), **kw)
            c.write_rows(slice(r, r + 1), one)
    else:
        # all but the last iteration replay CUDA graphs where they can
        n_split = n_iters - 1 if (devices is None
                                  and st.device.type == "cuda") else 0
        if n_split:
            c = shards[0][1]
            sp = _split_step(st, c.w2cs.shape[0], H=H, W=W,
                             use_ssim=use_ssim, alpha=alpha,
                             opt_poses=opt_poses, sh_degree=sh_degree,
                             iso_weight=iso_weight)
            sp.load(st, c, _split_scalars(lrs_at, cam_lrs, step0, n_split))
            for i in range(n_split):
                if i % rebin_every == 0:
                    with span("map.bin"):
                        tiles = _rebin(sp.s, sp.cam.w2cs, c.intrinsics,
                                       margin=rebin_margin, **bin_kw)
                sp.iterate(i, *tiles)
            sp.store(st, c)
        for i in range(n_split, n_iters - 1):
            if i % rebin_every == 0:
                with span("map.bin"):
                    for k, c in shards:
                        c.tile_ids, c.tile_counts = _rebin(
                            src(k), c.w2cs, c.intrinsics,
                            margin=rebin_margin, **bin_kw)
            step = step0 + i
            _step_shards(st, reps, shards, lrs_at(step), cam_lrs, step + 1,
                         iso_weight, want_touched=False, **kw)
        for _, c in shards:
            c.tile_ids = c.tile_counts = None
        step = step0 + n_iters - 1
        radii, n_touched, loss = _step_shards(
            st, reps, shards, lrs_at(step), cam_lrs, step + 1, iso_weight,
            want_touched=True, **kw)
    exp_state, tau_state, w2cs, exposure = _gather_cams(shards, st.device)
    return (st, exp_state, tau_state, w2cs, exposure, radii, n_touched,
            loss)


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

def _indexed(device):
    """`device` with its index: a CUDA device without one is the current."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_devices(n, device):
    """The devices `mapping.mesh_devices: n` splits the camera rows over:
    the run's device, then the other visible devices of its type in index
    order. None (one device) when n <= 1, and, with JAX's message, when
    fewer than n devices of that type are visible."""
    if n <= 1:
        return None
    if device.type == "cuda":
        first = _indexed(device).index
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        visible.sort(key=lambda d: d.index != first)
    else:
        visible = [device]
    if len(visible) < n:
        print(f"[mapper] mesh_devices={n} requested but only "
              f"{len(visible)} devices visible — running single-chip")
        return None
    return visible[:n]


class Mapper:
    def __init__(self, cfg, video, dataset, mono_loader=None, printer=None,
                 device=None, devices=None):
        """devices: the list of devices to split each optimisation
        segment's camera rows over, the first the run's device, in place of
        the one `mapping.mesh_devices` resolves to (a device may repeat)."""
        self.cfg = cfg
        self.video = video
        self.dataset = dataset
        self.mono_loader = mono_loader or (lambda idx: None)
        self.printer = printer
        self.device = resolve_device(device)
        if devices is None:
            devices = mesh_devices(
                int(cfg["mapping"].get("mesh_devices", 0) or 0), self.device)
        else:
            devices = [torch.device(d) for d in devices]
            if _indexed(devices[0]) != _indexed(self.device):
                raise ValueError(f"devices[0] {devices[0]} is not the "
                                 f"mapper's device {self.device}")
        self.devices = devices if devices and len(devices) > 1 else None

        m = cfg["mapping"]
        tr = m["Training"]
        self.alpha = tr["alpha"]
        self.use_ssim = tr["ssim_loss"]
        self.init_itr_num = tr["init_itr_num"]
        self.init_gaussian_update = tr["init_gaussian_update"]
        self.init_gaussian_reset = tr["init_gaussian_reset"]
        self.init_gaussian_th = tr["init_gaussian_th"]
        self.cameras_extent = 6.0
        self.init_gaussian_extent = self.cameras_extent * tr[
            "init_gaussian_extent"]
        self.mapping_itr_num = tr["mapping_itr_num"]
        self.gaussian_update_every = tr["gaussian_update_every"]
        self.gaussian_update_offset = tr["gaussian_update_offset"]
        self.gaussian_th = tr["gaussian_th"]
        self.gaussian_extent = self.cameras_extent * tr["gaussian_extent"]
        self.gaussian_reset = tr["gaussian_reset"]
        self.size_threshold = tr["size_threshold"]
        self.window_size = tr["window_size"]
        self.pose_window = tr["pose_window"]
        # in-mapper pose optimisation: mapping.BA and not gt_camera
        self.opt_poses_enabled = bool(m.get("BA", False)
                                      and not tr.get("gt_camera", False))
        self.lr_cam_rot = tr["lr"]["cam_rot_delta"]
        self.lr_cam_trans = tr["lr"]["cam_trans_delta"]
        self.kf_translation = tr["kf_translation"]
        self.kf_min_translation = tr["kf_min_translation"]
        self.kf_overlap = tr["kf_overlap"]
        self.kf_cutoff = tr.get("kf_cutoff", 0.4)
        self.prune_mode = tr["prune_mode"]
        self.move_points = m["move_points"]
        self.save_dir = None
        self.pcd_downsample = m["pcd_downsample"]
        self.pcd_downsample_init = m["pcd_downsample_init"]
        self.adaptive_pointsize = m["adaptive_pointsize"]
        self.point_size = m["point_size"]
        self.opt = m["opt_params"]
        self.spatial_lr_scale = 6.0

        self.H = cfg["cam"]["H_out"]
        self.W = cfg["cam"]["W_out"]
        self.K = m.get("raster_K", 256)
        self.rebin_every = m.get("rebin_every", 8)
        self.health_every = m.get("health_every", 10)
        self.online_plotting = m.get("online_plotting", False)
        self._mapped_count = 0
        self.max_span = m.get("raster_max_span", 4)
        self.eval_max_span = m.get("eval_max_span", 8)
        self.sh_degree = 3 if tr.get("spherical_harmonics", False) \
            else m["model_params"]["sh_degree"]
        cap = m.get("capacity", 1 << 17)
        self.st = G.make_state(cap, sh_degree=self.sh_degree,
                               device=self.device)
        # per-keyframe visibility rows (uid → row), row `buffer` is an
        # all-False read pad
        self.occ_vis = torch.zeros((video.buffer + 1, cap), dtype=torch.bool,
                                   device=self.device)
        self._alive_ub = 0
        self._last_w2cs = None

        self.iteration_count = 0
        self.cameras: dict[int, Camera] = {}
        self.viewpoints: dict[int, Camera] = {}
        self.current_window: list[int] = []
        self.depth_dict: dict[int, torch.Tensor] = {}
        self.is_kf: dict[int, bool] = {}
        self.keyframe_idxs: list[int] = []
        self.video_idxs: list[int] = []
        self.exp_ab: dict[int, np.ndarray] = {}
        self.exp_mv: dict[int, np.ndarray] = {}
        self.mono_cache: dict[int, tuple] = {}
        seed = cfg.get("setup_seed", 43)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.host_rng = np.random.RandomState(seed)
        self.initialized = False
        self.first_mapped_uid = None
        self.timers = PhaseTimers()   # replaced by SLAM's shared timers
        self.intrinsics = torch.as_tensor(dataset.get_intrinsic(),
                                          dtype=torch.float32,
                                          device=self.device)

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # -- proxy depth fusion (mapper.py:258-301) -----------------------------

    def _mono(self, frame_idx):
        ent = self.mono_cache.get(frame_idx)
        if ent is None:
            mono = self.mono_loader(frame_idx)
            if mono is None:
                ent = (torch.zeros((self.H, self.W), device=self.device),
                       False)
            else:
                ent = (self._tensor(mono), True)
            self.mono_cache[frame_idx] = ent
        return ent

    @torch.no_grad()
    def refresh_keyframes(self, pairs):
        """Batched get_w2c_and_depth for [(video_idx, frame_idx), ...]:
        returns {video_idx: (fused depth, w2c (np 4×4), invalid)} and
        writes the fitted mono scale/shift back to the tracker."""
        if not pairs:
            return {}
        s = self.video.state
        idx = torch.as_tensor([v for v, _ in pairs], device=self.device)
        monos = [self._mono(f) for _, f in pairs]
        has = torch.as_tensor([h for _, h in monos], device=self.device)
        fused, w2c, sc, sh, invalid = fusion.fuse_proxy_depth(
            s.disps_up[idx], s.valid_depth_mask[idx], s.poses[idx],
            torch.stack([m for m, _ in monos]), has)
        write = has & ~invalid
        s.depth_scale[idx[write]] = sc[write]
        s.depth_shift[idx[write]] = sh[write]
        w2c_np = w2c.cpu().numpy()
        inval = (invalid | ~has).cpu().numpy()
        return {v: (fused[i], w2c_np[i], bool(inval[i]))
                for i, (v, _) in enumerate(pairs)}

    # -- anchoring ----------------------------------------------------------

    @torch.no_grad()
    def add_next_kf(self, video_idx, cam: Camera, depth_map, init=False):
        down = self.pcd_downsample_init if init else self.pcd_downsample
        max_new = _round_up(int(2.0 * self.H * self.W / down), 1024)
        if self.adaptive_pointsize:
            point_size = min(0.05, self.point_size * float(
                nanmedian(depth_map.reshape(1, -1))[0]))
        else:
            point_size = self.point_size
        new = G.anchor_points(cam.image, depth_map, self._tensor(cam.w2c),
                              self.intrinsics, down, point_size, max_new,
                              generator=self.gen)
        self._alive_ub += max_new
        while self._alive_ub > 0.9 * self.st.capacity:
            self.st = G.grow_capacity(self.st)
            self.occ_vis = torch.cat(
                [self.occ_vis, torch.zeros_like(self.occ_vis)], 1)
        self.st = G.insert_points(self.st, new, video_idx)

    # -- rendering ----------------------------------------------------------

    def render_batch(self, cams):
        """Render several cameras in one batched call (eval path)."""
        w2cs = self._tensor(np.stack([c.w2c for c in cams]))
        return render_eval(self.st, w2cs, self.intrinsics, H=self.H,
                           W=self.W, K=self.K, sh_degree=self.sh_degree,
                           max_span=self.eval_max_span)

    # -- optimisation loops --------------------------------------------------

    def _stack_cams(self, cams):
        w2cs = self._tensor(np.stack([c.w2c for c in cams]))
        imgs = torch.stack([c.image for c in cams])
        zdep = torch.zeros((self.H, self.W), device=self.device)
        deps = torch.stack([c.depth if c.depth is not None else zdep
                            for c in cams])
        expo = self._tensor([self.exp_ab.get(c.uid, np.zeros(2))
                             for c in cams])
        use_exp = torch.as_tensor([c.uid != self.first_mapped_uid
                                   for c in cams], device=self.device)
        valid = torch.ones(len(cams), dtype=torch.bool, device=self.device)
        return w2cs, imgs, deps, expo, use_exp, valid

    def _run_iters(self, cams, iters, densify_cfg=None, store_expo=True,
                   opt_poses=False, n_window=0, iso_weight=ISO_WEIGHT,
                   persist_exp_state=False, per_step=False):
        """Shared optimisation loop of map/initialize_map/final_refine: runs
        map_step_n segments between densify/reset gates, handling each
        gate on the host in between."""
        if not cams:
            return None
        if per_step and densify_cfg is not None:
            per_step = False
        w2cs, imgs, deps, expo, use_exp, valid = self._stack_cams(cams)
        B = len(cams)
        if per_step and iters != B:
            raise ValueError(f"per_step needs one camera per iteration "
                             f"(got {B} cams, {iters} iters)")
        if persist_exp_state:
            mv = self._tensor([self.exp_mv.get(c.uid, np.zeros((2, 2)))
                               for c in cams])
            exp_m, exp_v = mv[:, 0].contiguous(), mv[:, 1].contiguous()
        else:
            exp_m, exp_v = torch.zeros_like(expo), torch.zeros_like(expo)
        tau_m = torch.zeros((B, 6), device=self.device)
        tau_v = torch.zeros((B, 6), device=self.device)
        n_opt = min(self.pose_window, n_window) if opt_poses else 0
        pose_mask_host = [i < n_opt and cams[i].uid != 0 for i in range(B)]
        pose_mask = torch.as_tensor(pose_mask_host, device=self.device)
        cam_lrs = (0.5 * self.lr_cam_trans, 0.5 * self.lr_cam_rot)
        op = self.opt
        lr_sched = (op["position_lr_init"] * self.spatial_lr_scale,
                    op["position_lr_final"] * self.spatial_lr_scale,
                    op["position_lr_delay_mult"],
                    op["position_lr_max_steps"])
        lrs_fixed = dict(xyz=0.0, f_dc=op["feature_lr"],
                         f_rest=op["feature_lr"] / 20.0,
                         opacity=op["opacity_lr"],
                         scaling=op["scaling_lr"] * self.spatial_lr_scale,
                         rotation=op["rotation_lr"])

        def host_events(it):
            d = densify_cfg
            if d is None:
                return False
            if d.get("update_every") and \
                    it % d["update_every"] == d.get("update_offset", 0):
                return True
            if it in d.get("reset_at", ()):
                return True
            return bool(d.get("reset_every")) and it % d["reset_every"] == 0

        done = 0
        last = None
        while done < iters:
            seg = 1
            while (done + seg < iters
                   and not host_events(self.iteration_count + seg)):
                seg += 1
            (self.st, (exp_m, exp_v), (tau_m, tau_v), w2cs, expo, radii,
             n_touched, loss) = map_step_n(
                self.st, (exp_m, exp_v), (tau_m, tau_v), w2cs, imgs, deps,
                expo, use_exp, valid, pose_mask, self.intrinsics, lrs_fixed,
                cam_lrs, self.iteration_count, seg, iso_weight,
                H=self.H, W=self.W, K=self.K, use_ssim=self.use_ssim,
                alpha=self.alpha, lr_sched=lr_sched, opt_poses=opt_poses,
                sh_degree=self.sh_degree, rebin_every=self.rebin_every,
                max_span=self.max_span, per_step_cams=per_step,
                devices=self.devices)
            self.iteration_count += seg
            done += seg
            last = (radii, n_touched, loss)
            if densify_cfg is not None:
                self._handle_host_events(densify_cfg, n_touched)
        if (store_expo or persist_exp_state or (opt_poses and n_opt)
                or densify_cfg is not None):
            with self.timers("map.pull"):
                # one read for the alive bound and Σ n_touched of the
                # last iteration (the JAX package's packed pull,
                # mapper.py:127-135)
                alive = self.st.alive.sum()
                blend = alive * 0 if last is None else last[1].sum()
                alive, blend = torch.stack([alive, blend]).tolist()
                self._alive_ub = int(alive)
                # JAX mapper.py:960-968, per iteration: ≈ 110 F per blend
                # pair (forward ≈ 30, backward ≈ 80), ≈ 500 F of projection
                # forward and backward per (camera, Gaussian) row, and the
                # loss ≈ 1.5 kF (SSIM) or 200 F per (camera, pixel)
                loss_f = 1500.0 if self.use_ssim else 200.0
                self.video.flops_mapping += float(iters) * (
                    float(blend) * 110.0 + B * self.st.capacity * 500.0
                    + B * self.H * self.W * loss_f)
                expo_np = expo.cpu().numpy()
                if store_expo:
                    for i, c in enumerate(cams):
                        self.exp_ab[c.uid] = expo_np[i]
                if persist_exp_state:
                    mv = torch.stack([exp_m, exp_v], 1).cpu().numpy()
                    for i, c in enumerate(cams):
                        self.exp_mv[c.uid] = mv[i]
                if n_opt:
                    w2c_np = w2cs.cpu().numpy()
                    for i, c in enumerate(cams):
                        if pose_mask_host[i]:
                            c.w2c = w2c_np[i].copy()
        self._last_w2cs = (tuple(c.uid for c in cams), w2cs)
        return last

    @torch.no_grad()
    def _handle_host_events(self, d, n_touched):
        """Densify/prune and opacity resets at gate iterations (the `elif`
        structure of mapper.py:531-556)."""
        with self.timers("map.densify"):
            it = self.iteration_count
            if d.get("update_every") and \
                    it % d["update_every"] == d.get("update_offset", 0):
                self.st = G.densify_and_prune(
                    self.st, self.opt["densify_grad_threshold"], d["th"],
                    d["extent"], d["size_threshold"],
                    self.opt["percent_dense"], generator=self.gen)
            elif d.get("reset_every") and it % d["reset_every"] == 0:
                vis_any = (n_touched[:d["n_window"]] > 0).any(0)
                self.st = G.reset_opacity_nonvisible(self.st, vis_any)
            if it in d.get("reset_at", ()):
                self.st = G.reset_opacity(self.st)

    def initialize_map(self, video_idx, cam: Camera):
        """First-keyframe optimisation (mapper.py:303-398)."""
        out = self._run_iters(
            [cam], self.init_itr_num,
            densify_cfg=dict(update_every=self.init_gaussian_update,
                             update_offset=0, th=self.init_gaussian_th,
                             extent=self.init_gaussian_extent,
                             size_threshold=None,
                             reset_at=(self.init_gaussian_reset,
                                       self.opt["densify_from_iter"])),
            store_expo=False)
        self.occ_vis[video_idx] = out[1][0] > 0
        return out

    def _capture_window_graphs(self):
        """Build map_step_n's graph path (_split_step) for every camera
        count a window's segment can have, up to window_size keyframes and
        two others, so that no capture falls inside the stream."""
        if self.devices is not None or self.device.type != "cuda":
            return
        for B in range(1, self.window_size + 3):
            _split_step(self.st, B, H=self.H, W=self.W,
                        use_ssim=self.use_ssim, alpha=self.alpha,
                        opt_poses=self.opt_poses_enabled,
                        sh_degree=self.sh_degree, iso_weight=ISO_WEIGHT)

    def _window_rows(self, window):
        """occ_vis rows of the window, padded to window_size with the
        all-False row."""
        rows = list(window[:self.window_size])
        rows += [self.video.buffer] * (self.window_size - len(rows))
        return torch.as_tensor(rows, device=self.device)

    @torch.no_grad()
    def _write_vis(self, window, n_touched):
        nw = min(len(window), n_touched.shape[0])
        self.occ_vis[torch.as_tensor(window[:nw], device=self.device)] = \
            n_touched[:nw] > 0

    def map(self, window, prune=False, iters=1):
        """Window optimisation (mapper.py:400-614); the two extra random
        past keyframes are drawn once per call."""
        if len(window) == 0:
            return
        cams = [self.viewpoints[k] for k in window]
        others = [v for k, v in self.viewpoints.items() if k not in window]
        if others:
            pick = self.host_rng.permutation(len(others))[:2]
            cams = cams + [others[int(i)] for i in pick]

        if prune:
            # the reference's prune pass renders for visibility and
            # returns before optimizer.step(); it counts as an iteration
            self.iteration_count += 1
            lw = self._last_w2cs
            if lw is not None and lw[0][:len(window)] == tuple(
                    self.viewpoints[k].uid for k in window):
                out = render_eval(self.st, lw[1], self.intrinsics, H=self.H,
                                  W=self.W, K=self.K,
                                  sh_degree=self.sh_degree,
                                  max_span=self.eval_max_span)
            else:
                out = self.render_batch([self.viewpoints[k] for k in window])
            self._write_vis(window, out.n_touched)
            if len(window) == self.window_size and \
                    self.prune_mode == "slam":
                n_obs = self.occ_vis[self._window_rows(window)].sum(0)
                min_kf = sorted(window, reverse=True)[2]
                to_prune = (n_obs <= 3) & (self.st.kf_id >= min_kf) \
                    & self.st.alive
                self.st = G.prune_by_mask(self.st, to_prune)
            return False

        out = self._run_iters(
            cams, iters,
            densify_cfg=dict(update_every=self.gaussian_update_every,
                             update_offset=self.gaussian_update_offset,
                             th=self.gaussian_th,
                             extent=self.gaussian_extent,
                             size_threshold=self.size_threshold,
                             reset_every=self.gaussian_reset,
                             n_window=len(window)),
            opt_poses=self.opt_poses_enabled, n_window=len(window))
        self._write_vis(window, out[1])
        return True

    def final_refine(self, iters=26000):
        """Global refinement (mapper.py:617-710): re-fuse depth/poses,
        deform once more, then optimise all Gaussian parameters and the
        exposures, one random keyframe per optimiser step (no isotropic
        term, no densification)."""
        self._refresh_and_deform(
            list(zip(self.video_idxs, self.keyframe_idxs)))
        vps = list(self.viewpoints.values())
        rng = np.random.RandomState(0)
        B = min(int(self.cfg["mapping"].get("refine_batch", 1)), len(vps))
        S = int(self.cfg["mapping"].get("refine_fused_steps", 8))
        per_step = (B == 1)
        if per_step:
            S = 1 if S == 1 else _round_up(S, 4)
            if self.devices is not None:
                # JAX's mesh bucket (mapper.py:1133-1140): both packages
                # draw the same schedule
                S = _round_up(S, math.lcm(4, len(self.devices)))
        done = 0
        while done < iters:
            if per_step:
                # without replacement within a segment when possible: a
                # duplicate row would drop a step's exposure update
                if len(vps) >= S:
                    pick = rng.choice(len(vps), size=S, replace=False)
                else:
                    pick = rng.randint(0, len(vps), size=S)
                self._run_iters([vps[i] for i in pick], S, iso_weight=0.0,
                                persist_exp_state=True, per_step=True)
            else:
                pick = rng.randint(0, len(vps), size=B)
                self._run_iters([vps[i] for i in pick], S, iso_weight=0.0,
                                persist_exp_state=True)
            done += S

    # -- keyframe management (mapper.py:744-831) -----------------------------

    def is_keyframe(self, cur_idx, last_idx, gate, median_depth):
        curr = self.cameras[cur_idx]
        last = self.cameras[last_idx]
        dist = float(np.linalg.norm(
            (np.asarray(curr.w2c) @ np.linalg.inv(
                np.asarray(last.w2c)))[:3, 3]))
        dist_check = dist > self.kf_translation * median_depth
        dist_check2 = dist > self.kf_min_translation * median_depth
        cvs, inter, osum = gate
        union = cvs + osum[0] - inter[0]
        ratio = inter[0] / max(union, 1)
        return (ratio < self.kf_overlap and dist_check2) or dist_check

    def add_to_window(self, cur_idx, gate, window):
        """gate counts align with `window` slots BEFORE cur_idx is
        prepended (mapper.py:769-831)."""
        cvs, inter, osum = gate
        N_dont_touch = 2
        window = [cur_idx] + window
        curr = self.cameras[cur_idx]
        to_remove = []
        removed = None
        for i in range(N_dont_touch, len(window)):
            denom = max(min(cvs, osum[i - 1]), 1)
            if inter[i - 1] / denom <= self.kf_cutoff:
                to_remove.append(window[i])
        if to_remove:
            window.remove(to_remove[-1])
            removed = to_remove[-1]
        if len(window) > self.window_size:
            inv_dist = []
            kf0_wc = np.linalg.inv(np.asarray(curr.w2c))
            for i in range(N_dont_touch, len(window)):
                ki_cw = np.asarray(self.cameras[window[i]].w2c)
                dists = []
                for j in range(N_dont_touch, len(window)):
                    if i == j:
                        continue
                    kj_wc = np.linalg.inv(np.asarray(
                        self.cameras[window[j]].w2c))
                    dists.append(1.0 / (np.linalg.norm(
                        (ki_cw @ kj_wc)[:3, 3]) + 1e-6))
                k = np.sqrt(np.linalg.norm((ki_cw @ kf0_wc)[:3, 3]))
                inv_dist.append(k * sum(dists))
            removed = window[N_dont_touch + int(np.argmax(inv_dist))]
            window.remove(removed)
        return window, removed

    # -- main entry (mapper.py:834-1116) -------------------------------------

    @torch.no_grad()
    def _refresh_and_deform(self, pairs, skip_frame_idx=None):
        """Refresh poses/depths for `pairs` and deform the Gaussians
        anchored to them (mapper.py:1021-1055, and final_refine's
        :621-648), all keyframes in one fusion and one deform call."""
        if not pairs:
            return
        res = self.refresh_keyframes(pairs)
        dirty = self.video.npc_dirty
        rows = []
        for v_idx, f_idx in pairs:
            depth_t, w2c_t, invalid_t = res[v_idx]
            dirty[v_idx] = False
            if v_idx not in self.depth_dict and self.is_kf.get(v_idx, False):
                self.depth_dict[v_idx] = depth_t
            if f_idx == skip_frame_idx:
                continue
            camk = self.cameras[v_idx]
            w2c_old = np.asarray(camk.w2c)
            camk.w2c = w2c_t
            camk.depth = depth_t
            if v_idx in self.viewpoints:
                self.viewpoints[v_idx].w2c = w2c_t
                self.viewpoints[v_idx].depth = depth_t
            if self.move_points and self.is_kf.get(v_idx, False):
                rows.append((v_idx, w2c_t, w2c_old, depth_t,
                             self.depth_dict.get(v_idx, depth_t), invalid_t))
                self.depth_dict[v_idx] = depth_t
        if not rows:
            return
        self.st = fusion.deform_points_batch(
            self.st, torch.as_tensor([r[0] for r in rows], device=self.device),
            self._tensor(np.stack([r[1] for r in rows])),
            self._tensor(np.stack([r[2] for r in rows])),
            torch.stack([r[3] for r in rows]),
            torch.stack([r[4] for r in rows]), self.intrinsics,
            torch.as_tensor([r[5] for r in rows], device=self.device))

    @torch.no_grad()
    def _fuse_and_gate(self, frame_idx, video_idx):
        """The new keyframe's proxy-depth fusion, its gate render at the
        fused pose, the render's median depth and the visibility counts
        against the current window (mapper.py:744-831 + 939-989).
        Returns (depth, w2c, invalid, median, (cur_vis, inter, occ_sum))."""
        res = self.refresh_keyframes([(video_idx, frame_idx)])
        depth, w2c, invalid = res[video_idx]
        # JAX mapper.py:1310-1316: fusion ≈ 500 F a pixel, the gate render
        # one projection over the capacity and a K-capped composite at
        # ~25% mean tile occupancy
        self.video.flops_mapping += float(self.H * self.W) * (
            500.0 + 0.25 * self.K * 110.0) + float(self.st.capacity) * 500.0
        out = render_eval(self.st, self._tensor(w2c)[None], self.intrinsics,
                          H=self.H, W=self.W, K=self.K,
                          sh_degree=self.sh_degree,
                          max_span=self.eval_max_span)
        med = get_median_depth(out.depth[0], out.alpha[0])
        cur = out.n_touched[0] > 0
        rows = self.occ_vis[self._window_rows(self.current_window)]
        inter = (rows & cur[None]).sum(1).float().cpu().numpy()
        osum = rows.sum(1).float().cpu().numpy()
        return depth, w2c, invalid, med, (float(cur.sum()), inter, osum)

    def process_keyframe(self, frame_idx, video_idx):
        """Handle one tracker keyframe; returns True if it was mapped."""
        T = self.timers
        with T("map.load"):
            _, color, _, _ = self.dataset[frame_idx]
            self._mono(frame_idx)
        self.keyframe_idxs.append(frame_idx)
        self.video_idxs.append(video_idx)

        with T("map.fuse"):
            depth, w2c, invalid, median_depth, gate = self._fuse_and_gate(
                frame_idx, video_idx)
        cam = make_camera(video_idx, color, depth, w2c, device=self.device)
        self.cameras[video_idx] = cam
        if invalid:
            self.is_kf[video_idx] = False
            return False

        if not self.initialized:
            self.initialized = True
            self.first_mapped_uid = video_idx
            self.current_window = [video_idx]
            self.depth_dict[video_idx] = depth
            self.is_kf[video_idx] = True
            self.viewpoints[video_idx] = cam
            with T("map.anchor"):
                self.add_next_kf(video_idx, cam, depth, init=True)
            with T("map.opt"):
                self.initialize_map(video_idx, cam)
                self._capture_window_graphs()
            return True

        if not np.isfinite(median_depth):
            d = depth[depth > 0]
            median_depth = float(nanmedian(d[None])[0]) if d.numel() else 1.0
        last_idx = self.current_window[0]
        create_kf = self.is_keyframe(video_idx, last_idx, gate, median_depth)
        if len(self.current_window) < self.window_size:
            cvs, inter, osum = gate
            union = cvs + osum[0] - inter[0]
            create_kf = inter[0] / max(union, 1) < self.kf_overlap
        if not create_kf:
            self.is_kf[video_idx] = False
            return False

        self.current_window, _ = self.add_to_window(
            video_idx, gate, self.current_window)
        self.is_kf[video_idx] = True

        # refresh mapped keyframes whose tracker pose/depth changed (the
        # tracker's npc_dirty flags) and deform the map
        last_frame_idx = self.keyframe_idxs[-1]
        dirty = self.video.npc_dirty
        with T("map.deform"):
            pairs = [(v, f)
                     for v, f in zip(self.video_idxs, self.keyframe_idxs)
                     if dirty[v] or v not in self.depth_dict
                     or f == last_frame_idx]
            self._refresh_and_deform(pairs, skip_frame_idx=last_frame_idx)

        self.viewpoints[video_idx] = cam
        with T("map.anchor"):
            self.add_next_kf(video_idx, cam, depth, init=False)
        with T("map.opt"):
            self.map(self.current_window, iters=self.mapping_itr_num)
            self.map(self.current_window, prune=True)
        self._mapped_count += 1
        if self.health_every and self._mapped_count % self.health_every == 0:
            self.log_raster_health()
        if self.online_plotting:
            self.plot_online(video_idx)
        return True

    @torch.no_grad()
    def log_raster_health(self):
        """Tile-list overflow beyond K and max_span crop over the current
        window; warns when the overflow exceeds 1%."""
        cams = [self.viewpoints[k] for k in self.current_window
                if k in self.viewpoints]
        if not cams:
            return None
        w2cs = self._tensor(np.stack([c.w2c for c in cams]))
        overflow, crop, max_count = rz.raster_health(
            self.st.xyz, G.get_scaling(self.st), self.st.rotation,
            G.get_opacity(self.st)[:, 0], self.st.alive, w2cs,
            w2cs.new_zeros(len(cams), 6), self.intrinsics, H=self.H,
            W=self.W, K=self.K, max_span=self.max_span)
        overflow, crop, max_count = float(overflow), float(crop), \
            int(max_count)
        msg = (f"raster health: tile overflow {overflow:.2%} "
               f"(K={self.K}, densest tile {max_count}), "
               f"max_span crop {crop:.2%}")
        emit = self.printer.print if self.printer else print
        if overflow > 0.01:
            emit(f"WARNING {msg} — overflow >1%: raise mapping.raster_K "
                 "or densify/prune more aggressively")
        else:
            emit(msg)
        return overflow, crop, max_count

    @torch.no_grad()
    def plot_online(self, video_idx):
        """Per-keyframe RGB/depth/diff panel under `online_plots/`
        (mapper.py:358-396,570-612); needs matplotlib."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        cam = self.viewpoints.get(video_idx)
        if cam is None:
            return
        out = self.render_batch([cam])
        img = torch.clamp(out.color[0], 0, 1).cpu().numpy()
        gt = cam.image.cpu().numpy()
        dep = out.depth[0].cpu().numpy()
        gtd = cam.depth.cpu().numpy() if cam.depth is not None else dep * 0
        fig, ax = plt.subplots(2, 3, figsize=(12, 6))
        for a, (im, title) in zip(ax.flat, [
                (gt, "gt rgb"), (img, "render"),
                (np.abs(gt - img).mean(-1), "|diff|"),
                (gtd, "proxy depth"), (dep, "render depth"),
                (np.abs(gtd - dep), "|depth diff|")]):
            a.imshow(im)
            a.set_title(title)
            a.axis("off")
        plot_dir = os.path.join(self.save_dir or ".", "online_plots")
        os.makedirs(plot_dir, exist_ok=True)
        fig.savefig(os.path.join(plot_dir, f"{video_idx:05d}.png"), dpi=80)
        plt.close(fig)
