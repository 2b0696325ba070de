"""Honeycomb core on PyTorch: the single-shard store, its host B+Tree and
its device read path."""
from .config import HoneycombConfig, bucket_pow2
from .btree import HoneycombTree, TreeStats
from .cache import CacheStats, InteriorCache
from .pipeline import PipelineStats
from .read_path import (GetResult, ScanResult, SnapshotDelta, TreeSnapshot,
                        apply_snapshot_delta, batched_get, batched_scan)
from .schema import FIELD_NAMES, NODE_SCHEMA, NodeImageLayout
from .shard import StagedSync, StoreShard, SyncStats
from .store import HoneycombStore

__all__ = [
    "HoneycombConfig", "bucket_pow2", "HoneycombTree",
    "TreeStats", "InteriorCache", "CacheStats", "PipelineStats",
    "TreeSnapshot", "SnapshotDelta", "ScanResult", "GetResult",
    "apply_snapshot_delta", "batched_get", "batched_scan", "FIELD_NAMES",
    "NODE_SCHEMA", "NodeImageLayout", "StoreShard", "StagedSync",
    "SyncStats", "HoneycombStore",
]
