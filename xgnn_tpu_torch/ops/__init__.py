"""Kernels and device ops of the port; the CUDA sources are in ``csrc/``."""
