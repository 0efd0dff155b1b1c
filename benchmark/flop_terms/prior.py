"""The monocular prior's FLOP term, under the kind "prior": one pass of
the omnidata DPT-Hybrid network (`models/dpt.DPTDepthModel.forward`),
counted from its input's shape at the network's published widths (a
frozen copy: the count does not read the program's model).

Counted, at 2 FLOPs a multiply-add and without bias terms: every
convolution of the ResNetV2-50 stem, the patch projection, the
positional grid's resize (two small matmuls), the 12 transformer blocks
(QKV, the two attention matmuls, the projection, the MLP), the readouts
and reassembly convolutions, the RefineNet decoder and the head. Not
counted: elementwise work (norms, the weight standardisation,
activations, the softmax, the bilinear upsamplings, the max-pool)."""

from splatslam_tpu_torch.models import dpt as dpt_mod

from . import Term

STAGES = ((3, 64, 256), (4, 128, 512), (9, 256, 1024))  # depth, mid, out
DIM, HEADS, MLP, BLOCKS, GRID = 768, 12, 3072, 12, 24
REASSEMBLE = (256, 512, 768, 768)
FEATURES = 256


def _conv(cin, cout, k, h, w):
    """A k×k convolution producing an (h, w) map."""
    return 2.0 * cin * cout * k * k * h * w


def _unit(h, w):
    """A residual unit of the decoder: two 3×3 convolutions."""
    return 2 * _conv(FEATURES, FEATURES, 3, h, w)


def dpt_pass(B, H, W):
    """FLOPs of one pass over a (B, 3, H, W) input, H and W multiples
    of 32."""
    h, w = H // 2, W // 2
    f = _conv(3, 64, 7, h, w)                         # stem convolution
    h, w = h // 2, w // 2                             # max-pool
    cin = 64
    for s, (depth, mid, out) in enumerate(STAGES):
        for b in range(depth):
            stride = 2 if (b == 0 and s > 0) else 1
            ho, wo = h // stride, w // stride
            f += _conv(cin, mid, 1, h, w) + _conv(mid, mid, 3, ho, wo) \
                + _conv(mid, out, 1, ho, wo)
            if b == 0:
                f += _conv(cin, out, 1, ho, wo)       # the shortcut
            cin, h, w = out, ho, wo
    gh, gw = H // 16, W // 16
    n = gh * gw + 1
    f += _conv(1024, DIM, 1, gh, gw)                  # patch projection
    f += 2.0 * DIM * (gh * GRID * GRID + gh * GRID * gw)
    f += BLOCKS * (2.0 * n * DIM * (3 * DIM + DIM + 2 * MLP)
                   + 4.0 * n * n * DIM)
    f += 2 * 2.0 * (n - 1) * 2 * DIM * DIM            # two readouts
    f += _conv(DIM, REASSEMBLE[2], 1, gh, gw) \
        + _conv(DIM, REASSEMBLE[3], 1, gh, gw) \
        + _conv(REASSEMBLE[3], REASSEMBLE[3], 3, gh // 2, gw // 2)
    sizes = ((H // 4, W // 4), (H // 8, W // 8), (gh, gw),
             (gh // 2, gw // 2))
    for cin, (h, w) in zip(REASSEMBLE, sizes):
        f += _conv(cin, FEATURES, 3, h, w)            # layer{i}_rn
    for i, (h, w) in enumerate(sizes):                # refinenet{i+1}
        f += _unit(h, w) * (1 if i == 3 else 2) \
            + _conv(FEATURES, FEATURES, 1, 2 * h, 2 * w)
    f += _conv(FEATURES, FEATURES // 2, 3, H // 2, W // 2) \
        + _conv(FEATURES // 2, 32, 3, H, W) + _conv(32, 1, 1, H, W)
    return B * f


def prior(orig, c, add):
    def f(model, x, *a, **kw):
        B, _, H, W = x.shape
        add(dpt_pass(B, H, W))
        return orig(model, x, *a, **kw)
    return f


TERMS = [Term(dpt_mod.DPTDepthModel, "forward", "prior", prior)]
