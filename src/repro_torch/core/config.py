"""Honeycomb store configuration (port of ``repro.core.config``).

Mirrors the paper's node geometry (Section 3.1) as fixed-width slots:

  paper                         here
  -----------------------------------------------------------------
  8 KB node                     ``node_cap`` sorted items + ``log_cap`` log
                                entries + ``n_shortcuts`` boundary keys
  48 B header                   SoA scalar columns (type/version/...)
  464 B shortcut block          ``n_shortcuts`` keys + segment offsets
  512 B log threshold           ``log_cap`` entries (merge when full)
  460 B max key                 ``key_words`` * 4 bytes (big-endian lanes)
  469 B max inline value        ``val_words`` * 4 bytes, larger values go
                                to the overflow heap (paper: out-of-node)
  5 B version delta             32-bit delta; wrap forces a merge, same as
                                the paper's wrap-forces-merge rule

Everything the reference's configs hold that the port runs:
``HoneycombConfig`` (both snapshot layouts, and the byte model the
benchmarks meter), ``DEFAULT_CONFIG``, ``bucket_pow2``, the
range-sharding config, the replication configs (feeds, relay topology,
read-spreading policies) and the service and telemetry configs.
"""
from __future__ import annotations

import dataclasses


# device-resident snapshot layouts (HoneycombConfig.layout)
LAYOUTS = ("packed", "legacy")

# device read-path backends (HoneycombConfig.read_backend):
#   "fused"     — ONE fused traversal launch per read batch: descend + leaf
#                 resolve + log merge + version resolution in a single kernel
#                 over the packed node image, the top interior levels served
#                 from the snapshot's cache array (kernels/fused_read.py).
#   "reference" — the per-level PyTorch path (core/read_path.py), kept as the
#                 op-for-op oracle the fused path is checked against.
READ_BACKENDS = ("fused", "reference")


def bucket_pow2(n: int) -> int:
    """Round a batch/delta length up to a power of two (1 for n <= 1).

    THE shared bucket schedule for everything padded before a device
    call — read batches and delta row/page-table vectors (core/shard.py) —
    identical to the reference's, so padded lane counts and sync meters
    agree between the two packages."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class HoneycombConfig:
    # --- node geometry -----------------------------------------------------
    node_cap: int = 64          # max items in the sorted block
    log_cap: int = 16           # log entries before a merge is forced
    n_shortcuts: int = 8        # boundary keys in the shortcut block
    key_words: int = 8          # key lanes (uint32, big-endian) => 32 B max key
    val_words: int = 4          # inline value lanes => 16 B inline values
    min_fill: float = 0.25      # leaf underflow threshold (merge w/ sibling)
    split_fill: float = 0.5     # target fill of each half after a split

    # --- MVCC / GC ----------------------------------------------------------
    mvcc: bool = True           # paper Section 3.2; False => version 0 for all
    max_version_chain: int = 4  # bound on old-version hops a reader may take
    gc_batch: int = 64          # GC list scan granularity

    # --- read path ----------------------------------------------------------
    max_height: int = 8         # static traversal bound of the device reader
    max_scan_leaves: int = 4    # sibling hops a single SCAN may take
    max_scan_items: int = 32    # result slots per SCAN request

    # --- accelerator cache / load balancer (Section 5) ----------------------
    cache_slots: int = 256      # interior-node cache capacity (packed array)
    cache_ways: int = 4         # set associativity of the metadata table
    load_balance: bool = True   # route some cache hits to the slow path
    lb_fast_fraction: float = 0.75  # fraction of hits served by the cache path
    # device cache tier: how many tree levels from the root are packed into
    # the snapshot's contiguous cache array; lb_fraction is the Section 5
    # dual-pipe knob — the fraction of cache-HIT level lookups the fused
    # kernel routes back to the heap-image pipe anyway (results are
    # identical either way; only the byte split between the pipes moves).
    cache_levels: int = 2
    lb_fraction: float = 0.0

    # --- value overflow heap -----------------------------------------------
    overflow_words: int = 128   # slot size of the out-of-node value heap

    # --- host->device sync (delta snapshots, paper Sections 3-4) ------------
    # "on_read": sync lazily before a device batch (default, paper-like);
    # "every_k": sync after every sync_every_k writes (batched sync);
    # "explicit": only export_snapshot() syncs — device reads may observe a
    #             stale-but-consistent snapshot.
    sync_policy: str = "on_read"
    sync_every_k: int = 64
    # dirty-row fraction above which a delta sync would move more bytes than
    # a wholesale republish is worth; fall back to a full publish
    delta_full_threshold: float = 0.5
    # device-resident snapshot representation (core/schema.py):
    # "packed": ONE contiguous u32 node image per slot — a dirty node syncs
    #           as a single image-row copy (the paper's 8 KB node transfer);
    # "legacy": per-field tensors — every field's dirty rows scatter in one
    #           multi-field kernel launch, kept as the packed layout's
    #           op-for-op parity reference.
    layout: str = "packed"
    # device read-path backend (see READ_BACKENDS above); a legacy-layout
    # snapshot carries no packed image for the fused kernel, so that layout
    # always reads through the "reference" path
    read_backend: str = "fused"

    def __post_init__(self):
        assert self.node_cap % self.n_shortcuts == 0, (
            "segments must tile the sorted block")
        assert self.log_cap <= 255, "order hints are 1 byte (paper Fig. 7)"
        assert self.node_cap <= 2 ** 15, "back pointers are 2 bytes"
        assert self.sync_policy in ("on_read", "every_k", "explicit"), (
            f"unknown sync_policy {self.sync_policy!r}")
        assert 0.0 < self.delta_full_threshold <= 1.0, (
            "delta_full_threshold is a dirty fraction in (0, 1]")
        assert self.sync_every_k >= 1, "sync_every_k must be >= 1"
        assert self.layout in LAYOUTS, (
            f"unknown snapshot layout {self.layout!r} (one of {LAYOUTS})")
        assert self.read_backend in READ_BACKENDS, (
            f"unknown read_backend {self.read_backend!r} "
            f"(one of {READ_BACKENDS})")
        assert self.cache_levels >= 1, "cache the root level at least"
        assert 0.0 <= self.lb_fraction <= 1.0, (
            "lb_fraction is a routed fraction in [0, 1]")

    @property
    def segment_items(self) -> int:
        """Items per sorted-block segment (the unit a search fetches)."""
        return self.node_cap // self.n_shortcuts

    @property
    def max_key_bytes(self) -> int:
        return self.key_words * 4

    @property
    def max_inline_val_bytes(self) -> int:
        return self.val_words * 4

    # Byte model of the benchmarks' bytes-fetched accounting (paper
    # Section 3.1: "a search reads at most 1.5 KB of an 8 KB node"), the
    # reference's formulas.  Sizes are the packed lane widths gathered.
    @property
    def header_bytes(self) -> int:
        return 48

    @property
    def shortcut_bytes(self) -> int:
        return self.n_shortcuts * (self.max_key_bytes + 4)

    @property
    def segment_bytes(self) -> int:
        return self.segment_items * (self.max_key_bytes + self.val_words * 4 + 4)

    @property
    def log_bytes(self) -> int:
        return self.log_cap * (self.max_key_bytes + self.val_words * 4 + 12)

    @property
    def node_bytes(self) -> int:
        return (self.header_bytes + self.shortcut_bytes
                + self.node_cap * (self.max_key_bytes + self.val_words * 4 + 4)
                + self.log_bytes)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Observability knobs (core/telemetry.py).

    ``enabled=False`` skips telemetry construction entirely: no registry,
    no histograms, no tracer — the scheduler hot path pays only ``is
    None`` branches.  ``trace_sample_rate`` samples per-request lifecycle
    traces deterministically (every ``round(1/rate)``-th request; 0
    disables tracing and allocates nothing); finished traces are retained
    in a ring buffer of ``trace_capacity``.  The histogram geometry knobs
    pin the log-bucket resolution of every latency histogram the service
    records."""
    enabled: bool = True
    trace_sample_rate: float = 0.0
    trace_capacity: int = 256
    latency_lo: float = 1e-7         # histogram range floor (seconds)
    latency_hi: float = 1e3          # histogram range ceiling (seconds)
    buckets_per_decade: int = 16     # log-bucket resolution

    def __post_init__(self):
        assert 0.0 <= self.trace_sample_rate <= 1.0, (
            "trace_sample_rate is a probability in [0, 1]")
        assert self.trace_capacity >= 1, "trace ring needs >= 1 slot"
        assert 0.0 < self.latency_lo < self.latency_hi, (
            "histogram range must satisfy 0 < lo < hi")
        assert self.buckets_per_decade >= 1


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving-front-end knobs for ``HoneycombService`` (core/api.py).

    ``batch_size`` is the dense device-batch target the scheduler fills per
    (shard, replica, kind, cost_class) bucket; ``cost_classes`` the
    expected-work buckets SCANs are split into; ``pipeline`` the epoch
    composition (``"serial"`` waits for the sync on the device before any
    read dispatches, ``"pipelined"`` stages and flips without waiting —
    core/scheduler.py); ``telemetry`` the observability knobs
    (core/telemetry.py)."""
    batch_size: int = 256
    cost_classes: tuple[int, ...] = (1, 4, 16, 64)
    pipeline: str = "serial"
    telemetry: TelemetryConfig = TelemetryConfig()

    def __post_init__(self):
        assert self.batch_size >= 1, "batch_size must be >= 1"
        assert self.cost_classes, "need at least one cost class"
        from .pipeline import PIPELINE_MODES
        assert self.pipeline in PIPELINE_MODES, (
            f"unknown pipeline mode {self.pipeline!r} "
            f"(one of {PIPELINE_MODES})")


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Range partition of the keyspace for ``ShardedHoneycombStore``.

    ``boundaries`` are ``shards - 1`` strictly ascending byte-string split
    points; shard ``i`` owns keys in ``[boundaries[i-1], boundaries[i])``
    (shard 0 is unbounded below, the last shard unbounded above).  ``None``
    defaults to a uniform split of the 8-byte big-endian integer keyspace.
    """
    shards: int = 1
    boundaries: tuple[bytes, ...] | None = None

    def __post_init__(self):
        assert self.shards >= 1, "need at least one shard"
        if self.boundaries is not None:
            b = self.boundaries
            assert len(b) == self.shards - 1, (
                f"{self.shards} shards need {self.shards - 1} boundaries, "
                f"got {len(b)}")
            assert all(x < y for x, y in zip(b, b[1:])), (
                "shard boundaries must be strictly ascending")


# follower feed paths for replicated shards (core/replica.py):
#   "log"   — ship each sync epoch's op wire stream (core/api.py codec) once
#             and replay it on device with the log_replay_scatter kernel;
#             epochs whose tree shape changed fall back to the image delta.
#   "delta" — ship the primary's dirty-row image delta to every follower
#             (the pre-log feed, kept as the byte-accounting reference).
REPLICA_FEEDS = ("log", "delta")


@dataclasses.dataclass(frozen=True)
class FeedTopology:
    """Relay tree for the replication feed (core/replica.py).

    ``depth == 0`` is the flat feed: the primary ships every staged payload
    directly to each follower, so feeder egress is O(replicas).  With
    ``depth >= 1`` followers are arranged level by level under the primary —
    up to ``fanout`` first-level relays, ``fanout**2`` second-level nodes,
    and so on, with the final level absorbing any remainder round-robin —
    so the primary's egress is O(fanout) and each relay forwards the SAME
    encoded payload downstream (the architecture of "Reliable Replication
    Protocols on SmartNICs", PAPERS.md).  A paused relay cuts off its
    subtree: descendants miss the payload, fall out of sync, and take a
    full-image catch-up from the primary once the path is live again.
    """
    fanout: int = 2
    depth: int = 0

    def __post_init__(self):
        assert self.fanout >= 1, "relay fanout must be >= 1"
        assert self.depth >= 0, "relay depth must be >= 0"

    def parents(self, n_followers: int) -> dict[int, int]:
        """Map follower replica id (1..n) -> feeding parent replica id
        (0 = primary).  Levels 1..depth-1 take ``fanout`` children per
        parent in id order; the last level absorbs every remaining
        follower, spread round-robin over the level above."""
        ids = list(range(1, n_followers + 1))
        if self.depth == 0:
            return {i: 0 for i in ids}
        parents: dict[int, int] = {}
        prev_level = [0]
        pos = 0
        for level in range(1, self.depth + 1):
            remaining = len(ids) - pos
            if remaining <= 0:
                break
            cap = len(prev_level) * self.fanout
            take = remaining if level == self.depth else min(remaining, cap)
            this_level = ids[pos:pos + take]
            for idx, i in enumerate(this_level):
                if take <= cap:
                    parents[i] = prev_level[idx // self.fanout]
                else:        # final level overflow: spread round-robin
                    parents[i] = prev_level[idx % len(prev_level)]
            prev_level = this_level
            pos += take
        return parents


# read-spreading policies for replicated shards (core/replica.py):
#   "primary_only" — every read serves from the primary (replication off the
#                    read path; the replicas=1 equivalence baseline);
#   "round_robin"  — dispatched read batches rotate over the replica set;
#   "least_loaded" — each batch goes to the replica that has served the
#                    fewest requests so far.
REPLICA_POLICIES = ("primary_only", "round_robin", "least_loaded")


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Replica set for each shard of a ``ShardedHoneycombStore``.

    ``replicas`` counts SERVING copies per shard (primary + followers), so
    ``replicas=1`` means no followers — the configuration that is
    operation-for-operation identical to the unreplicated store, including
    sync byte counts (held to the reference by
    tests/test_torch_replication.py).  Followers hold
    their own device-resident snapshot fed only by the primary's delta
    stream (core/replica.py); ``policy`` picks how the router spreads read
    batches over the replica set (writes always go to the primary).

    ``feed`` selects the follower transport: ``"log"`` (default) ships each
    epoch's encoded op stream once and replays it on device, falling back
    per-epoch to the image delta when the tree shape changed; ``"delta"``
    is the pre-log dirty-row image feed.  ``topology`` arranges followers
    into a relay tree (see ``FeedTopology``) so feeder egress scales with
    the fanout, not the replica count.
    """
    replicas: int = 1
    policy: str = "primary_only"
    feed: str = "log"
    topology: FeedTopology = FeedTopology()

    def __post_init__(self):
        assert self.replicas >= 1, "need at least the primary replica"
        assert self.policy in REPLICA_POLICIES, (
            f"unknown replica policy {self.policy!r} "
            f"(one of {REPLICA_POLICIES})")
        assert self.feed in REPLICA_FEEDS, (
            f"unknown replica feed {self.feed!r} (one of {REPLICA_FEEDS})")
        assert isinstance(self.topology, FeedTopology), (
            "topology must be a FeedTopology")


DEFAULT_CONFIG = HoneycombConfig()
