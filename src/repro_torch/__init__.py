"""Honeycomb ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same module and
class names, the store's snapshots on an NVIDIA GPU, and hand-written CUDA
kernels for the fused GET/SCAN traversal, the delta-sync row scatter, the
legacy layout's multi-field scatter and the replication feed's log
replay.  It imports neither ``jax`` nor ``repro``.
"""
from .core import (NOT_FOUND, OK, Delete, Get, HoneycombConfig,
                   HoneycombService, HoneycombStore, OutOfOrderScheduler, Put,
                   ReplicationConfig, Response, Scan, ServiceConfig,
                   ShardedHoneycombStore, TelemetryConfig, Ticket, Update)

__all__ = ["HoneycombConfig", "HoneycombStore", "ReplicationConfig",
           "ShardedHoneycombStore", "HoneycombService", "ServiceConfig",
           "TelemetryConfig", "OutOfOrderScheduler", "Get", "Scan", "Put",
           "Update", "Delete", "Response", "Ticket", "OK", "NOT_FOUND"]
