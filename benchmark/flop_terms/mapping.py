"""The mapper's FLOP terms, under the kind "mapping": the iterations of a
mapping segment and a keyframe's fusion and gate render."""

from splatslam_tpu_torch.mapping import mapper as mapper_mod

from .. import flops as F
from . import Term


def map_n(orig, c, add):
    def f(st, *a, **kw):
        if not c.active:
            return orig(st, *a, **kw)
        alive = st.alive.sum()
        n_iters, B = a[13], a[2].shape[0]
        out = orig(st, *a, **kw)
        add(F.map_iterations(n_iters, B, alive, out[6].sum(), c.hw))
        return out
    return f


def gate(orig, c, add):
    def f(mapper, *a, **kw):
        if c.active:
            add(F.gate_render(c.hw, c.K, mapper.st.alive.sum()))
        return orig(mapper, *a, **kw)
    return f


TERMS = [
    Term(mapper_mod, "map_step_n", "mapping", map_n),
    Term(mapper_mod.Mapper, "_fuse_and_gate", "mapping", gate),
]
