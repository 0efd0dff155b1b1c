"""The benchmark of splatslam_tpu_torch, the PyTorch/CUDA port: streaming
dense SLAM measured on one NVIDIA H100 (run.py)."""
