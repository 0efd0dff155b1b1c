"""The comparison that decides `correct`: each stage the window drove,
taken at one call (probes.Capture), worked out again by the plain float32
reference (reference/) and judged by a number with a limit of its own.

The reference follows the program step by step: a stage starts from the
program's state as the call found it (poses, disparities, the GRU's
hidden state, the map's parameters and Adam moments, the camera batch)
and from the run's frames, and recomputes the stage's outputs itself: the
encoders from the frames, the network from its own reading of the
checkpoint, the correlation, the solve, the render and its gradient. The
numbers (all relative, all ≥ 0):

  scan_gap    the admission scan of a chunk: features and context of each
              frame (relative L2) and each frame's flow magnitude
              (largest error over the mean), under the program's own
              admissions;
  update_gap  the update operator over an edge set: the flow revision,
              the confidence, the damping and the hidden state (relative
              L2, the largest of the four);
  dba_gap     a bundle-adjustment solve, worked out again in float64:
              the change it makes to where each edge's pixels reproject
              (relative L2 over the call's edges). Float64, because two
              float32 runs of one solve (atomic sums in another order)
              part by about as much as TF32 moves it: the float32 answer
              is itself only known to its rounding, amplified by the
              solve. The reprojection, not the raw pose and disparity
              updates: those move freely along the solve's weakly
              determined directions;
  render_gap  the mapping iteration's render through B1: colour (largest
              absolute error) and depth (largest error over the mean
              depth);
  step_gap    the same iteration's loss (relative), its gradient through
              B2 (relative L2, the worst leaf, each leaf measured against
              its own norm or the median leaf's, whichever is larger;
              leaves whose reference gradient is under a thousandth of
              the median leaf's are not compared), and the Adam step the
              program took from that gradient (the worst leaf's update,
              relative L2).

`control` recomputes each stage with the reference in the precision
below the one the configuration states and reads the same numbers of it
against the reference: the network's bf16 convolutions in fp8 e4m3 with
a per-tensor scale; the float32 matmuls of the correlation in TF32; the
solve in TF32 and in bfloat16 storage; the mapping iteration, float32
code without matmuls, in bfloat16 storage (every tensor the stage reads
and writes rounded to bf16, the arithmetic between in float32: no more
error than computing it in bf16 would make). TF32 alone leaves the
solve within its own float32 spread: at these shapes its products run on
cuBLAS's small-N SIMT kernels, which TF32 does not reach, and its error
is that of its elementwise float32 arithmetic, for which the precision
below is bf16.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .reference import ba as ref_ba
from .reference import mapping as ref_map
from .reference import tracking as ref_tr

STAGES = ("scan", "update", "dba", "map")
NUMBERS = {"scan": "scan_gap", "update": "update_gap", "dba": "dba_gap",
           "map": ("render_gap", "step_gap")}
LEAF_FLOOR = 1e-3


def _rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


@contextlib.contextmanager
def lower_precision(model=None):
    """The control: TF32 for float32 matmuls and convolutions, and the
    network's convolutions (if a network is given) on fp8 e4m3 inputs and
    weights, each scaled per tensor to the format's range."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    saved = []

    def q(t):
        s = torch.clamp(t.abs().amax(), min=1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s

    if model is not None:
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                saved.append((m, m.forward))
                m.forward = (lambda m_: lambda x: m_._conv_forward(
                    q(x), q(m_.weight), m_.bias))(m)
    try:
        yield
    finally:
        for m, f in saved:
            m.forward = f
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _bf16(x):
    if isinstance(x, dict):
        return {k: _bf16(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_bf16(v) for v in x)
    if torch.is_tensor(x) and x.is_floating_point():
        return x.bfloat16().float()
    return x


def _u8(frame):
    """A frame as the loop hands it to the tracker: uint8 0-255."""
    return torch.as_tensor((np.asarray(frame) * 255.0).astype(np.uint8))


# ---------------------------------------------------------------------------
# the stages, worked out again
# ---------------------------------------------------------------------------

def scan(model, cap, device):
    """Reference outputs of the admission scan: (gmaps, nets, inps,
    deltas), the chain following the program's admissions."""
    gmaps, nets, inps = ref_tr.encode(model, cap["images"].to(device))
    admits = cap["out"][0][:gmaps.shape[0]] > 0.5
    fmap, net_c, inp_c = (cap["fmap0"].float(), cap["net0"].float(),
                          cap["inp0"].float())
    deltas = []
    for k in range(gmaps.shape[0]):
        deltas.append(ref_tr.flow_magnitude(model, fmap, gmaps[k], net_c,
                                            inp_c))
        if admits[k]:
            fmap, net_c, inp_c = gmaps[k], nets[k], inps[k]
    return gmaps, nets, inps, torch.stack(deltas)


def scan_gap(prog, ref):
    pack, gmaps, nets, inps = prog
    C = gmaps.shape[0]
    d_ref = ref[3]
    d_err = float((pack[C:] - d_ref).abs().max()
                  / torch.clamp(d_ref.abs().mean(), min=1e-30))
    return max(_rel(gmaps, ref[0]), _rel(nets, ref[1]), _rel(inps, ref[2]),
               d_err)


def update(model, cap, frames, device):
    """Reference outputs of the update operator. The features and context
    of each keyframe the edges touch are encoded again from its frame."""
    ii, jj = cap["ii"], cap["jj"]
    rows = torch.unique(torch.cat([ii, jj])).tolist()
    n = cap["poses"].shape[0]
    imgs = torch.stack([_u8(frames[int(round(cap["timestamps"][r]))])
                        for r in rows]).to(device)
    f, _, inp = ref_tr.encode(model, imgs)
    fmaps = f.new_zeros((n,) + f.shape[1:])
    inps = inp.new_zeros((n,) + inp.shape[1:])
    idx = torch.as_tensor(rows, device=device)
    fmaps[idx], inps[idx] = f, inp
    return ref_tr.update_operator(model, cap["poses"], cap["disps"],
                                  cap["intrinsics"], fmaps, inps,
                                  cap["net"].float(), cap["target"], ii, jj)


def update_gap(prog, ref):
    net, target, weight, eta, _, _, coords1 = prog
    r_net, r_target, r_weight, r_eta, _, r_coords1 = ref
    return max(_rel(target - coords1, r_target - r_coords1),
               _rel(weight, r_weight), _rel(eta, r_eta), _rel(net, r_net))


def dba(cap, dtype=torch.float64):
    """The solve in `dtype` (float64 for the reference, float32 for the
    control), its result in float32."""
    edges = ref_ba.make_edges(cap["ii"], cap["jj"], cap["t0"], cap["t1"],
                              cap["ii"].device)
    c = lambda k: None if cap[k] is None else cap[k].to(dtype)
    poses, disps = ref_ba.dba(c("poses"), c("disps"), c("intrinsics"),
                              c("target"), c("weight"), c("eta"),
                              c("sensor"), edges, iters=cap["iters"],
                              lm=cap["lm"], ep=cap["ep"],
                              motion_only=cap["motion_only"])
    return poses.float(), disps.float()


def dba_gap(cap, prog, ref):
    ii, jj, intr = cap["ii"], cap["jj"], cap["intrinsics"]
    moved = lambda out: (ref_tr.reproject(out[0], out[1], intr, ii, jj)[0]
                         - ref_tr.reproject(cap["poses"], cap["disps"],
                                            intr, ii, jj)[0])
    return _rel(moved(prog), moved(ref))


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


# ---------------------------------------------------------------------------
# judging a run
# ---------------------------------------------------------------------------

def readings(got, model, frames, device):
    """{number: program's reading} for every captured stage, and the
    reference outputs they were read against (for the control)."""
    out, refs = {}, {}
    # the reference's precision is the benchmark's to set, whatever the
    # program left switched
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        if "scan" in got:
            c = got["scan"]
            refs["scan"] = scan(model, c, device)
            out["scan_gap"] = scan_gap(c["out"], refs["scan"])
        if "update" in got:
            c = got["update"]
            refs["update"] = update(model, c, frames, device)
            out["update_gap"] = update_gap(c["out"], refs["update"])
        if "dba" in got:
            c = got["dba"]
            refs["dba"] = dba(c)
            out["dba_gap"] = dba_gap(c, c["out"], refs["dba"])
    if "map" in got:
        c = got["map"]
        refs["map"] = map_step(c)
        out["render_gap"] = render_gap(c["color"], c["depth"], refs["map"])
        out["step_gap"] = step_gap(c, c["loss"], c["grads"], c["post"],
                                   refs["map"])
    return out, refs


def control_readings(got, refs, model, frames, device):
    """The same numbers, with the reference in the precision below the
    configuration's put in the program's place."""
    out = {}
    with torch.no_grad():
        if "scan" in got:
            with lower_precision(model):
                r = scan(model, got["scan"], device)
            C = r[0].shape[0]
            pack = torch.cat([torch.zeros(C, device=device), r[3]])
            out["scan_gap"] = scan_gap((pack,) + tuple(r[:3]), refs["scan"])
        if "update" in got:
            with lower_precision(model):
                r = update(model, got["update"], frames, device)
            out["update_gap"] = update_gap(r[:5] + (None, r[5]),
                                           refs["update"])
        if "dba" in got:
            c = got["dba"]
            with lower_precision():
                r = _bf16(dba(_bf16(c), torch.float32))
            out["dba_gap"] = dba_gap(c, r, refs["dba"])
    if "map" in got:
        c = got["map"]
        r = _bf16(map_step(_bf16(c)))
        post = _bf16(ref_map.adam(_bf16(c["params"]), _bf16(c["m"]),
                                  _bf16(c["v"]), r[3], c["alive"],
                                  c["lrs"], c["step"]))
        out["render_gap"] = render_gap(r[0], r[1], refs["map"])
        out["step_gap"] = step_gap(c, r[2], r[3], post, refs["map"])
    return out


def numbers(stage):
    n = NUMBERS[stage]
    return (n,) if isinstance(n, str) else n


def wanted(limits):
    """The stages a cell's limits cover, in order."""
    return [s for s in STAGES if all(n in limits for n in numbers(s))]


def judge(values, limits):
    """(correct, {number: {"value", "limit"}}): every limited number was
    read (its stage came), is finite, and is within its limit."""
    table, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        table[name] = {"value": v, "limit": lim}
        ok &= v is not None and bool(np.isfinite(v)) and v <= lim
    return ok, table
