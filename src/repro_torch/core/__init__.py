"""Honeycomb core on PyTorch: the single-shard store, its host B+Tree and
device read path, the range-sharded router, replication and the op wire
codec."""
from .config import (REPLICA_FEEDS, REPLICA_POLICIES, FeedTopology,
                     HoneycombConfig, ReplicationConfig, ShardingConfig,
                     bucket_pow2)
from .api import (OPS_BY_KIND, WIRE_ENTRY_OVERHEAD, WRITE_KINDS, Delete, Get,
                  Put, Scan, Update, WireDecodeError, decode_wire,
                  decode_wire_stream, wire_entry_nbytes)
from .btree import HoneycombTree, TreeStats
from .cache import CacheStats, InteriorCache
from .pipeline import PipelineStats
from .read_path import (GetResult, ScanResult, SnapshotDelta, TreeSnapshot,
                        apply_snapshot_delta, batched_get, batched_scan)
from .schema import FIELD_NAMES, NODE_SCHEMA, LogReplayOffsets, NodeImageLayout
from .shard import LogPayload, StagedSync, StoreShard, SyncStats
from .store import HoneycombStore
from .replica import FeedStats, FollowerReplica, ReplicaGroup
from .router import (ShardedHoneycombStore, aggregate_stats,
                     uniform_int_boundaries)
from .telemetry import merge_stats

__all__ = [
    "HoneycombConfig", "bucket_pow2", "ShardingConfig", "ReplicationConfig",
    "FeedTopology", "REPLICA_FEEDS", "REPLICA_POLICIES",
    "Get", "Scan", "Put", "Update", "Delete", "OPS_BY_KIND", "WRITE_KINDS",
    "WIRE_ENTRY_OVERHEAD", "WireDecodeError", "decode_wire",
    "decode_wire_stream", "wire_entry_nbytes", "HoneycombTree",
    "TreeStats", "InteriorCache", "CacheStats", "PipelineStats",
    "TreeSnapshot", "SnapshotDelta", "ScanResult", "GetResult",
    "apply_snapshot_delta", "batched_get", "batched_scan", "FIELD_NAMES",
    "NODE_SCHEMA", "NodeImageLayout", "LogReplayOffsets", "StoreShard",
    "StagedSync", "LogPayload", "SyncStats", "HoneycombStore", "FeedStats",
    "FollowerReplica", "ReplicaGroup", "ShardedHoneycombStore",
    "aggregate_stats", "uniform_int_boundaries", "merge_stats",
]
