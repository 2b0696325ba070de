"""Honeycomb ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same module and
class names, the store's snapshots on an NVIDIA GPU, and hand-written CUDA
kernels for the fused GET/SCAN traversal, the delta-sync row scatter and
the replication feed's log replay.
It imports neither ``jax`` nor ``repro``.
"""
from .core import (HoneycombConfig, HoneycombStore, ReplicationConfig,
                   ShardedHoneycombStore)

__all__ = ["HoneycombConfig", "HoneycombStore", "ReplicationConfig",
           "ShardedHoneycombStore"]
