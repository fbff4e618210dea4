"""Build and load the CUDA kernels of csrc/."""
