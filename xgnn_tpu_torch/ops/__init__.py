"""Kernels and device ops of the port; the CUDA sources are in ``csrc/``."""

from .unique import unique_ordered  # noqa: F401,E402
