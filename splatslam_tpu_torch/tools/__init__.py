"""Checkpoint tools of the port (counterparts of the JAX repository's
tools/flow_probe.py, tools/admission_calib.py and tools/ate_matrix.py):
run as `python -m splatslam_tpu_torch.tools.<name>`."""
