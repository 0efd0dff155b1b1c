"""The last iteration of a mapping segment (`mapping/mapper._step_shards`
with one shard and no replicas, its render through
`ops/rasterizer.rasterize_batch` and the gradient it hands
`mapping/gaussians.adam_step`).

  render_gap  the render through B1: colour (largest absolute error) and
              depth (largest error over the mean depth);
  step_gap    the iteration's loss (relative), its gradient through B2
              (relative L2, the worst leaf, each leaf measured against its
              own norm or the median leaf's, whichever is larger; leaves
              whose reference gradient is under a thousandth of the median
              leaf's are not compared), and the Adam step the program took
              from that gradient (the worst leaf's update, relative L2).

Control: the iteration, float32 code without matmuls, in bfloat16
storage.
"""

from __future__ import annotations

import numpy as np
import torch

from splatslam_tpu_torch.mapping import gaussians as G
from splatslam_tpu_torch.mapping import mapper as mapper_mod
from splatslam_tpu_torch.ops import rasterizer as rz

from ..check import _bf16, _rel
from ..probes import clone
from ..reference import mapping as ref_map

NUMBERS = ("render_gap", "step_gap")
LEAF_FLOOR = 1e-3


def arm(slot, p):
    pending = {}        # the capture of the iteration in flight

    def step(orig):
        def f(st, reps, shards, lrs, cam_lrs, step_, iso_weight, **kw):
            if slot.full or not kw.get("want_touched") \
                    or len(shards) != 1 or reps:
                return orig(st, reps, shards, lrs, cam_lrs, step_,
                            iso_weight, **kw)
            c = shards[0][1]
            cap = dict(
                params={n: clone(getattr(st, n)) for n in G.PARAM_NAMES},
                m={n: clone(getattr(st, f"m_{n}")) for n in G.PARAM_NAMES},
                v={n: clone(getattr(st, f"v_{n}")) for n in G.PARAM_NAMES},
                alive=clone(st.alive), w2cs=clone(c.w2cs),
                images=clone(c.images), depths=clone(c.depths),
                exposure=clone(c.exposure),
                use_exposure=clone(c.use_exposure),
                cam_valid=clone(c.cam_valid),
                intrinsics=clone(c.intrinsics), lrs=dict(lrs),
                step=step_, iso_weight=iso_weight,
                kw={k: kw[k] for k in ("H", "W", "K", "use_ssim", "alpha",
                                       "sh_degree", "max_span")})
            pending["map"] = cap
            try:
                out = orig(st, reps, shards, lrs, cam_lrs, step_,
                           iso_weight, **kw)
            finally:
                pending.clear()
            cap["post"] = {n: clone(getattr(st, n)) for n in G.PARAM_NAMES}
            cap["loss"] = clone(out[2])
            slot.put(cap)
            return out
        return f

    def render(orig):
        def f(*a, **kw):
            out = orig(*a, **kw)
            cap = pending.get("map")
            if cap is not None and "color" not in cap:
                cap["color"] = clone(out.color)
                cap["depth"] = clone(out.depth)
            return out
        return f

    def adam(orig):
        def f(st, grads, lrs, step_, *a, **kw):
            cap = pending.get("map")
            if cap is not None and "grads" not in cap:
                cap["grads"] = clone(grads)
            return orig(st, grads, lrs, step_, *a, **kw)
        return f

    p.put(mapper_mod, "_step_shards", step)
    p.put(rz, "rasterize_batch", render)
    p.put(G, "adam_step", adam)


def map_step(cap):
    kw = cap["kw"]
    return ref_map.step(cap["params"], cap["alive"], cap["w2cs"],
                        cap["images"], cap["depths"], cap["exposure"],
                        cap["use_exposure"], cap["cam_valid"],
                        cap["intrinsics"], cap["iso_weight"], H=kw["H"],
                        W=kw["W"], K=kw["K"], alpha=kw["alpha"],
                        max_span=kw["max_span"])


def render_gap(prog_color, prog_depth, ref):
    color, depth = ref[0], ref[1]
    return max(float((prog_color - color).abs().max()),
               float((prog_depth - depth).abs().max()
                     / torch.clamp(depth.abs().mean(), min=1e-30)))


def step_gap(cap, prog_loss, prog_grads, prog_post, ref):
    _, _, loss, grads = ref
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    med = float(np.median(list(norms.values())))
    leaves = [n for n in grads if norms[n] >= LEAF_FLOOR * med]
    gap = abs(float(prog_loss) - float(loss)) / max(abs(float(loss)), 1e-30)
    for n in leaves:
        err = float(torch.linalg.vector_norm(prog_grads[n] - grads[n]))
        gap = max(gap, err / max(norms[n], med))
    # the step the program took from its own gradient
    post = ref_map.adam(cap["params"], cap["m"], cap["v"], prog_grads,
                        cap["alive"], cap["lrs"], cap["step"])
    for n in leaves:
        gap = max(gap, _rel(prog_post[n] - cap["params"][n],
                            post[n] - cap["params"][n]))
    return gap


def reference(ctx, cap):
    return map_step(cap)


def gaps(cap, ref):
    return {"render_gap": render_gap(cap["color"], cap["depth"], ref),
            "step_gap": step_gap(cap, cap["loss"], cap["grads"],
                                 cap["post"], ref)}


def control(ctx, cap, ref):
    r = _bf16(map_step(_bf16(cap)))
    post = _bf16(ref_map.adam(_bf16(cap["params"]), _bf16(cap["m"]),
                              _bf16(cap["v"]), r[3], cap["alive"],
                              cap["lrs"], cap["step"]))
    return {"render_gap": render_gap(r[0], r[1], ref),
            "step_gap": step_gap(cap, r[2], r[3], post, ref)}
