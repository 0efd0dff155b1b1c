"""Tools of the port: the checkpoint tools (counterparts of the JAX
repository's tools/flow_probe.py, tools/admission_calib.py and
tools/ate_matrix.py) and the per-layer profilers (tools/kernel_bench.py,
tools/map_step_profile.py, tools/tracking_profile.py); run as
`python -m splatslam_tpu_torch.tools.<name>`."""
