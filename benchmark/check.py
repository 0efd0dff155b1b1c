"""The comparison that decides `correct`: each stage the window drove,
taken at one call (probes.Capture), worked out again by the plain
reference (reference/) and judged by numbers with limits of their own.
Each stage is a file of its own (stages/<stage>.py, whose docstring
defines its numbers); what every stage shares is here.

The reference follows the program step by step: a stage starts from the
program's state as the call found it (poses, disparities, the GRU's
hidden state, the map's parameters and Adam moments, the camera batch)
and from the run's frames, and recomputes the stage's outputs itself: the
encoders from the frames, the network from its own reading of the
checkpoint, the correlation, the solve, the render and its gradient.
Every number is relative and ≥ 0.

A stage's `control` recomputes it with the reference in the precision
below the one the configuration states, in the program's place, and
reads the same numbers of it against the reference: fp8 e4m3 for bf16
convolutions, TF32 for float32 matmuls, and bfloat16 storage for float32
code whose products TF32 does not reach (`lower_precision`, `_bf16`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .stages import name


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
    """bfloat16 storage: every floating tensor rounded to bf16 and back
    (the arithmetic between stays float32: no more error than computing
    in bf16 would make)."""
    if isinstance(x, dict):
        return {k: _bf16(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_bf16(v) for v in x)
    if torch.is_tensor(x) and x.is_floating_point():
        return x.bfloat16().float()
    return x


def readings(got, ctx, stages):
    """{number: program's reading} for every captured stage of `stages`,
    and the reference outputs they were read against (for the control)."""
    out, refs = {}, {}
    # the reference's precision is the benchmark's to set, whatever the
    # program left switched
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for s in stages:
        if name(s) in got:
            cap = got[name(s)]
            refs[name(s)] = s.reference(ctx, cap)
            out.update(s.gaps(cap, refs[name(s)]))
    return out, refs


def control_readings(got, refs, ctx, stages):
    """The same numbers, with the reference in the precision below the
    configuration's put in the program's place."""
    out = {}
    for s in stages:
        if name(s) in got:
            out.update(s.control(ctx, got[name(s)], refs[name(s)]))
    return out


def judge(values, limits):
    """(correct, {number: {"value", "limit"}}): every limited number was
    read (its stage came), is finite, and is within its limit."""
    table, ok = {}, True
    for n, lim in limits.items():
        v = values.get(n)
        table[n] = {"value": v, "limit": lim}
        ok &= v is not None and bool(np.isfinite(v)) and v <= lim
    return ok, table
