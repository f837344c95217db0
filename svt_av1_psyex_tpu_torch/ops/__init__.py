"""Kernels of the port: plain PyTorch versions and hand-written CUDA."""
