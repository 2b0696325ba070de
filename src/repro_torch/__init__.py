"""Honeycomb ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same module and
class names, the store's snapshot on an NVIDIA GPU, and hand-written CUDA
kernels for the fused GET/SCAN traversal and the delta-sync row scatter.
It imports neither ``jax`` nor ``repro``.
"""
from .core import HoneycombConfig, HoneycombStore

__all__ = ["HoneycombConfig", "HoneycombStore"]
