"""The benchmark of `pathtracer_tpu_torch`, the PyTorch and CUDA port of
the path tracer, on NVIDIA H100 cards. See ptbench/README.md."""
