"""The benchmark's FLOP model: a frozen copy of the JAX package's
coefficients (as the port's producers apply them, `DepthVideo.flops_*`),
applied to the sizes the benchmark reads at the layer entries it wraps
(probes.Counters).

Where the program's counters multiply by the Gaussian buffer's padded
capacity, this model takes the live Gaussians of the call (the alive
rows): it counts what the inputs need, not what a padded buffer holds.
Per-iteration mapping work uses the live (pixel, Gaussian) pairs that
the segment's last iteration composited (Σ n_touched), as the program's
counter does, for every iteration of the segment.

Each function returns FLOPs as a float, or as a 0-d device tensor where a
count lives on the device (read after the window, without a sync in it).
"""

ENCODER_PER_PIXEL = 8e3          # one encoder pass, per input pixel
UPDATE_PER_EDGE_PIXEL = 2.8e6    # update operator, per 1/8-res edge pixel
ORACLE_PER_EDGE_PIXEL = 2e3      # GT-flow reprojection, per edge pixel
BA_PER_EDGE_PIXEL = 1.5e3        # one Gauss-Newton iteration, per edge pixel
DISTANCE_PER_PIXEL = 1.2e3       # one frame distance, per 1/8-res pixel
BLEND_PER_PAIR = 110.0           # composite forward + backward, per pair
PROJECT_PER_GAUSSIAN = 500.0     # projection forward + backward, per row
LOSS_PER_PIXEL = 200.0           # L1 colour + depth loss, per pixel
FUSION_PER_PIXEL = 500.0         # proxy-depth fusion, per pixel
GATE_TILE_OCCUPANCY = 0.25       # K-capped gate composite: mean occupancy


def encoder(hw):
    return hw * ENCODER_PER_PIXEL


def admission(chunk, hw, h8w8):
    """Both encoders over a chunk and one update step per frame."""
    return chunk * (2 * encoder(hw) + h8w8 * UPDATE_PER_EDGE_PIXEL)


def update_operator(edges, h8w8):
    return edges * h8w8 * UPDATE_PER_EDGE_PIXEL


def oracle_targets(edges, h8w8):
    return edges * h8w8 * ORACLE_PER_EDGE_PIXEL


def ba_iterations(iters, edges, h8w8):
    return iters * edges * h8w8 * BA_PER_EDGE_PIXEL


def frame_distance(pairs, h8w8):
    return pairs * h8w8 * DISTANCE_PER_PIXEL


def map_iterations(iters, cams, alive, live_pairs, hw):
    """`iters` mapping iterations over `cams` cameras; `alive` and
    `live_pairs` may be device tensors."""
    return iters * (live_pairs * BLEND_PER_PAIR
                    + cams * alive * PROJECT_PER_GAUSSIAN
                    + cams * hw * LOSS_PER_PIXEL)


def gate_render(hw, K, alive):
    """A keyframe's fusion and gate render; `alive` may be a device
    tensor."""
    return (hw * (FUSION_PER_PIXEL + GATE_TILE_OCCUPANCY * K * BLEND_PER_PAIR)
            + alive * PROJECT_PER_GAUSSIAN)
