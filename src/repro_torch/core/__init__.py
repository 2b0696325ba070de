"""Honeycomb core on PyTorch: the single-shard store, its host B+Tree and
device read path (packed and legacy layouts), the range-sharded router,
replication, the typed service front end with its out-of-order scheduler,
and telemetry."""
from .config import (DEFAULT_CONFIG, REPLICA_FEEDS, REPLICA_POLICIES,
                     FeedTopology, HoneycombConfig, ReplicationConfig,
                     ServiceConfig, ShardingConfig, TelemetryConfig,
                     bucket_pow2)
from .telemetry import (CLOCK, Clock, Histogram, MetricSample,
                        MetricsRegistry, Span, Telemetry, Trace, Tracer,
                        chrome_trace_events, merge_stats, parse_prometheus,
                        prom_value)
from .api import (NOT_FOUND, OK, OPS_BY_KIND, WIRE_ENTRY_OVERHEAD,
                  WRITE_KINDS, Delete, Get, HoneycombService, Put, Response,
                  Routing, Scan, Ticket, Update, WireDecodeError, decode_wire,
                  decode_wire_stream, wire_entry_nbytes)
from .btree import HoneycombTree, TreeStats
from .cache import CacheStats, InteriorCache
from .pipeline import PIPELINE_MODES, PipelineStats
from .read_path import (GetResult, LegacySnapshotDelta, LegacyTreeSnapshot,
                        ScanResult, SnapshotDelta, TreeSnapshot,
                        apply_snapshot_delta, batched_get, batched_scan)
from .schema import FIELD_NAMES, NODE_SCHEMA, LogReplayOffsets, NodeImageLayout
from .shard import LogPayload, StagedSync, StoreShard, SyncStats
from .store import HoneycombStore
from .replica import FeedStats, FollowerReplica, ReplicaGroup
from .router import (ShardedHoneycombStore, aggregate_stats,
                     uniform_int_boundaries)
from .scheduler import OutOfOrderScheduler, Request

__all__ = [
    "HoneycombConfig", "DEFAULT_CONFIG", "bucket_pow2", "ShardingConfig", "ReplicationConfig",
    "FeedTopology", "REPLICA_FEEDS", "REPLICA_POLICIES", "ServiceConfig",
    "TelemetryConfig",
    "Get", "Scan", "Put", "Update", "Delete", "OPS_BY_KIND", "WRITE_KINDS",
    "WIRE_ENTRY_OVERHEAD", "WireDecodeError", "decode_wire",
    "decode_wire_stream", "wire_entry_nbytes", "OK", "NOT_FOUND",
    "Response", "Ticket", "Routing", "HoneycombService", "HoneycombTree",
    "TreeStats", "InteriorCache", "CacheStats", "PIPELINE_MODES",
    "PipelineStats", "TreeSnapshot", "SnapshotDelta", "LegacyTreeSnapshot",
    "LegacySnapshotDelta", "ScanResult", "GetResult",
    "apply_snapshot_delta", "batched_get", "batched_scan", "FIELD_NAMES",
    "NODE_SCHEMA", "NodeImageLayout", "LogReplayOffsets", "StoreShard",
    "StagedSync", "LogPayload", "SyncStats", "HoneycombStore", "FeedStats",
    "FollowerReplica", "ReplicaGroup", "ShardedHoneycombStore",
    "aggregate_stats", "uniform_int_boundaries", "OutOfOrderScheduler",
    "Request", "CLOCK", "Clock", "Histogram", "MetricSample",
    "MetricsRegistry", "Span", "Telemetry", "Trace", "Tracer",
    "chrome_trace_events", "merge_stats", "parse_prometheus", "prom_value",
]
