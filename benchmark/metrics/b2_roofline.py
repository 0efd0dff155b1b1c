"""B2 (`composite_bwd`, csrc/composite.cu) as a share of its roofline."""

from ._roofline import share


def read(rec):
    return share(rec, "composite_bwd")
