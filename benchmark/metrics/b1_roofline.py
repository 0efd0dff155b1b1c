"""B1 (`composite_fwd`, csrc/composite.cu) as a share of its roofline."""

from ._roofline import share


def read(rec):
    return share(rec, "composite_fwd")
