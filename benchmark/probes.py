"""Wrappers the benchmark puts around the program's layer entries.

Two kinds, installed when they are first needed (a traced run's trace
window, or the arming of the check) into one `Patches` that the run
removes as a whole once its loop has stopped:

  * `Counters` (traced runs only): the work each layer was handed, counted
    from the arguments at its entry, for the frozen FLOP model (flops.py),
    and each compositing-kernel launch's sizes for the kernels' bounds
    (bounds.py). Device-side counts stay device tensors until the trace
    window has closed, so counting adds no host synchronisation.
  * `Capture` (every run): the inputs and outputs of one call of each
    checked stage, cloned, for the comparison with the reference
    (check.py). Armed late in the window; each stage is taken once, at its
    first call after arming.

A wrapper replaces a module attribute that the program looks up at call
time (a module-level function, or a method on its class) and calls the
original, so the program runs unchanged beneath it.
"""

from __future__ import annotations

import torch

from splatslam_tpu_torch.mapping import gaussians as G
from splatslam_tpu_torch.mapping import mapper as mapper_mod
from splatslam_tpu_torch.ops import ba as ba_ops
from splatslam_tpu_torch.ops import raster_cuda
from splatslam_tpu_torch.ops import rasterizer as rz
from splatslam_tpu_torch.tracking import depth_video as dv_mod
from splatslam_tpu_torch.tracking import factor_graph as fg_mod
from splatslam_tpu_torch.tracking import motion_filter as mf_mod

from . import flops as F


class Patches:
    """Module attributes replaced by wrappers, put back by `remove`."""

    def __init__(self):
        self._saved = []

    def put(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def remove(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


def _clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class Counters:
    """What the layers were handed while installed: FLOPs by the frozen
    model (device tensors summed at `read`), and one record per launch of
    B1/B2: (name, B, N, T, K, pairs, live pairs or None)."""

    def __init__(self, H, W, K):
        self.H, self.W, self.K = H, W, K
        self.active = False
        self.flops = []          # (kind, float or 0-d device tensor)
        self.launches = []
        self._live = {}          # B1's live pairs by packets' data pointer

    def install(self, p):
        """Wrap the layer entries (into Patches `p`); they count while
        `active` is set."""
        h8w8 = (self.H // 8) * (self.W // 8)
        hw = self.H * self.W

        def add(x, kind="tracking"):
            if self.active:
                self.flops.append((kind, x))

        def scan(orig):
            def f(model, images_u8, *a, **kw):
                add(F.admission(images_u8.shape[0], hw, h8w8))
                return orig(model, images_u8, *a, **kw)
            return f

        def encoder(orig):
            def f(model, image, *a, **kw):
                add(F.encoder(hw))
                return orig(model, image, *a, **kw)
            return f

        def update(orig):
            def f(model, poses, disps, intrinsics, fmaps, inps, net, target,
                  ii, jj, *a, **kw):
                add(F.update_operator(ii.shape[0], h8w8))
                return orig(model, poses, disps, intrinsics, fmaps, inps,
                            net, target, ii, jj, *a, **kw)
            return f

        def oracle(orig):
            def f(graph):
                add(F.oracle_targets(len(graph.ii), h8w8))
                return orig(graph)
            return f

        def dba(orig):
            def f(poses, disps, intrinsics, target, weight, eta,
                  sensor_disps, edges, iters=2, *a, **kw):
                add(F.ba_iterations(iters, edges.ii.shape[0], h8w8))
                return orig(poses, disps, intrinsics, target, weight, eta,
                            sensor_disps, edges, iters, *a, **kw)
            return f

        def scale_shift(orig):
            def f(*a, **kw):
                edges = a[10] if len(a) > 10 else kw["edges"]
                add(F.ba_iterations(1, edges.ii.shape[0], h8w8))
                return orig(*a, **kw)
            return f

        def distance(orig):
            def f(poses, disps, intrinsics, ii, jj, *a, **kw):
                add(F.frame_distance(ii.shape[0], h8w8))
                return orig(poses, disps, intrinsics, ii, jj, *a, **kw)
            return f

        def map_n(orig):
            def f(st, *a, **kw):
                if not self.active:
                    return orig(st, *a, **kw)
                alive = st.alive.sum()
                n_iters, B = a[13], a[2].shape[0]
                out = orig(st, *a, **kw)
                add(F.map_iterations(n_iters, B, alive, out[6].sum(), hw),
                    "mapping")
                return out
            return f

        def gate(orig):
            def f(mapper, *a, **kw):
                if self.active:
                    add(F.gate_render(hw, self.K, mapper.st.alive.sum()),
                        "mapping")
                return orig(mapper, *a, **kw)
            return f

        def fwd(orig):
            def f(packets, tile_ids, counts, ntx, want_touched=True):
                out, nt = orig(packets, tile_ids, counts, ntx, want_touched)
                if not self.active:
                    return out, nt
                live = nt.sum() if want_touched else None
                self._live[packets.data_ptr()] = live
                self._launch("composite_fwd", packets, tile_ids, counts,
                             live)
                return out, nt
            return f

        def bwd(orig):
            def f(packets, tile_ids, counts, ntx, gout, fwdout):
                grad = orig(packets, tile_ids, counts, ntx, gout, fwdout)
                if not self.active:
                    return grad
                self._launch("composite_bwd", packets, tile_ids, counts,
                             self._live.pop(packets.data_ptr(), None))
                return grad
            return f

        p.put(mf_mod, "admission_scan", scan)
        p.put(mf_mod, "encode_features", encoder)
        p.put(mf_mod, "encode_context", encoder)
        p.put(fg_mod, "update_operator", update)
        p.put(fg_mod.FactorGraph, "_oracle_targets", oracle)
        p.put(ba_ops, "dba", dba)
        p.put(ba_ops, "_scale_shift_iteration", scale_shift)
        p.put(dv_mod, "frame_distance", distance)
        p.put(fg_mod, "frame_distance", distance)
        p.put(mapper_mod, "map_step_n", map_n)
        p.put(mapper_mod.Mapper, "_fuse_and_gate", gate)
        p.put(raster_cuda, "composite_fwd", fwd)
        p.put(raster_cuda, "composite_bwd", bwd)

    def _launch(self, name, packets, tile_ids, counts, live):
        B, N, _ = packets.shape
        _, T, K = tile_ids.shape
        pairs = 256 * torch.clamp(counts, max=K).sum()
        self.launches.append((name, B, N, T, K, pairs, live))

    def read(self):
        """({"tracking": FLOPs, "mapping": FLOPs}, launches with pairs and
        live pairs as ints)."""
        total = {"tracking": 0.0, "mapping": 0.0}
        for kind, x in self.flops:
            total[kind] += float(x)
        launches = [(n, B, N, T, K, int(p), None if lv is None else int(lv))
                    for n, B, N, T, K, p, lv in self.launches]
        return total, launches


class Capture:
    """One call of each checked stage, taken at its first call after
    `arm()`: `scan` (the admission scan of a chunk), `update` (the update
    operator over an edge set), `dba` (a bundle-adjustment solve) and
    `map` (the last iteration of a mapping segment: the render, the
    gradient that Adam is handed, the step). Stages the configuration
    does not run are not waited for (`wanted`). The update operator's
    capture keeps the keyframes' timestamps of `video`, which name the
    frames the reference encodes again."""

    def __init__(self, wanted, video):
        self.wanted = set(wanted)
        self.video = video
        self.armed = False
        self.got = {}
        self._map = None

    @property
    def complete(self):
        return self.wanted <= set(self.got)

    def arm(self, p):
        """Wrap the checked stages (into Patches `p`)."""
        got = self.got
        self.armed = True

        def scan(orig):
            def f(model, images_u8, fmap0, net0, inp0, thresh):
                if "scan" in got:
                    return orig(model, images_u8, fmap0, net0, inp0, thresh)
                cap = dict(images=_clone(images_u8), fmap0=_clone(fmap0),
                           net0=_clone(net0), inp0=_clone(inp0),
                           thresh=float(thresh))
                out = orig(model, images_u8, fmap0, net0, inp0, thresh)
                cap["out"] = _clone(out)
                got["scan"] = cap
                return out
            return f

        def update(orig):
            def f(model, poses, disps, intrinsics, fmaps, inps, net, target,
                  ii, jj, pyramid=None):
                if "update" in got:
                    return orig(model, poses, disps, intrinsics, fmaps, inps,
                                net, target, ii, jj, pyramid)
                cap = dict(poses=_clone(poses), disps=_clone(disps),
                           intrinsics=_clone(intrinsics), net=_clone(net),
                           target=_clone(target), ii=_clone(ii),
                           jj=_clone(jj), timestamps=_clone(
                               self.video.state.timestamp).cpu().numpy())
                out = orig(model, poses, disps, intrinsics, fmaps, inps, net,
                           target, ii, jj, pyramid)
                cap["out"] = _clone(out)
                got["update"] = cap
                return out
            return f

        def dba(orig):
            def f(poses, disps, intrinsics, target, weight, eta,
                  sensor_disps, edges, iters=2, lm=1e-4, ep=0.1,
                  motion_only=False):
                if "dba" in got or poses.dim() != 2:
                    return orig(poses, disps, intrinsics, target, weight,
                                eta, sensor_disps, edges, iters, lm, ep,
                                motion_only)
                cap = dict(poses=_clone(poses), disps=_clone(disps),
                           intrinsics=_clone(intrinsics),
                           target=_clone(target), weight=_clone(weight),
                           eta=_clone(eta), sensor=_clone(sensor_disps),
                           ii=_clone(edges.ii), jj=_clone(edges.jj),
                           t0=edges.t0, t1=edges.t1, iters=iters, lm=lm,
                           ep=ep, motion_only=motion_only)
                out = orig(poses, disps, intrinsics, target, weight, eta,
                           sensor_disps, edges, iters, lm, ep, motion_only)
                cap["out"] = _clone(out)
                got["dba"] = cap
                return out
            return f

        def step(orig):
            def f(st, reps, shards, lrs, cam_lrs, step_, iso_weight, **kw):
                if "map" in got or not kw.get("want_touched") \
                        or len(shards) != 1 or reps:
                    return orig(st, reps, shards, lrs, cam_lrs, step_,
                                iso_weight, **kw)
                c = shards[0][1]
                cap = dict(
                    params={n: _clone(getattr(st, n)) for n in G.PARAM_NAMES},
                    m={n: _clone(getattr(st, f"m_{n}"))
                       for n in G.PARAM_NAMES},
                    v={n: _clone(getattr(st, f"v_{n}"))
                       for n in G.PARAM_NAMES},
                    alive=_clone(st.alive), w2cs=_clone(c.w2cs),
                    images=_clone(c.images), depths=_clone(c.depths),
                    exposure=_clone(c.exposure),
                    use_exposure=_clone(c.use_exposure),
                    cam_valid=_clone(c.cam_valid),
                    intrinsics=_clone(c.intrinsics), lrs=dict(lrs),
                    step=step_, iso_weight=iso_weight,
                    kw={k: kw[k] for k in ("H", "W", "K", "use_ssim",
                                           "alpha", "sh_degree",
                                           "max_span")})
                self._map = cap
                try:
                    out = orig(st, reps, shards, lrs, cam_lrs, step_,
                               iso_weight, **kw)
                finally:
                    self._map = None
                cap["post"] = {n: _clone(getattr(st, n))
                               for n in G.PARAM_NAMES}
                cap["loss"] = _clone(out[2])
                got["map"] = cap
                return out
            return f

        def render(orig):
            def f(*a, **kw):
                out = orig(*a, **kw)
                if self._map is not None and "color" not in self._map:
                    self._map["color"] = _clone(out.color)
                    self._map["depth"] = _clone(out.depth)
                return out
            return f

        def adam(orig):
            def f(st, grads, lrs, step_, *a, **kw):
                if self._map is not None and "grads" not in self._map:
                    self._map["grads"] = _clone(grads)
                return orig(st, grads, lrs, step_, *a, **kw)
            return f

        if "scan" in self.wanted:
            p.put(mf_mod, "admission_scan", scan)
        if "update" in self.wanted:
            p.put(fg_mod, "update_operator", update)
        p.put(ba_ops, "dba", dba)
        p.put(mapper_mod, "_step_shards", step)
        p.put(rz, "rasterize_batch", render)
        p.put(G, "adam_step", adam)
