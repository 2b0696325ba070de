"""Baselines the benchmarks hold Honeycomb against: the software-only
ordered store that stands in for the paper's eRPC-Masstree."""
from .cpu_store import CpuOrderedStore, CpuStoreStats

__all__ = ["CpuOrderedStore", "CpuStoreStats"]
