"""splatslam_tpu_torch — the PyTorch/CUDA port of splatslam_tpu.

Dense RGB SLAM with Splat-SLAM's capabilities: DSPO bundle adjustment
over a keyframe graph and a deformable 3D Gaussian Splatting map. The
JAX package `splatslam_tpu` is the reference; this package mirrors its
layout module for module (ops/, tracking/, mapping/, utils/, slam.py)
and imports neither jax nor anything of `splatslam_tpu`.

Everything that the JAX package leaves to XLA is plain PyTorch here.
The two Pallas kernels of the JAX package (the 3DGS tile compositor's
forward and backward, `splatslam_tpu/ops/raster_pallas.py`) are CUDA C++
kernels for sm_90a in `csrc/composite.cu`, bound through
`ops/raster_cuda.py`.

Entry point: `python -m splatslam_tpu_torch.run <config.yaml>`; it runs
on the GPU unless `--device cpu` is given.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch device a run uses: CUDA unless the caller names another.

    Raises when CUDA is requested (the default) but no GPU is present —
    the port never moves to the CPU on its own."""
    import torch
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run the "
            "plain PyTorch path on the CPU")
    return dev
