"""ShardedHoneycombStore — the range-sharded, replicated store (port of
``repro.core.router``).

The keyspace is range-partitioned across N shards — each with its OWN
tree, resident device snapshot, incremental delta sync and ``SyncStats`` —
behind the same ``put/get/scan/get_batch/scan_batch/export_snapshot``
facade, with a request router in front:

  * writes route to the owning shard; each shard syncs independently (a
    write burst confined to one shard delta-syncs only that shard), and
    each dirty shard stages (``begin_export``) and flips (``flip``) on its
    own.
  * ``get_batch`` splits by owning shard and dispatches one dense device
    batch per shard; responses scatter back to arrival order.
  * cross-shard SCANs decompose into per-shard sub-ranges — sub-range s >
    first starts at the shard's lower boundary, so per-shard floor-start
    semantics compose exactly — and results stitch in key order.  When
    the first shard holds no key <= lo, the global floor item (largest key
    <= lo, Section 3.3) is back-filled from the nearest non-empty shard to
    the left, with extra per-shard SCAN batches.
  * no shard ever talks to another; the router stitches on the host.  On
    one GPU the shards are logical units whose snapshots share the card.
  * every shard slot is a ``ReplicaGroup`` (core/replica.py): one primary
    plus the ``ReplicationConfig``-configured followers, each a device
    image fed only by the primary's staged syncs.  The group's
    read-spreading policy pins each dispatched batch to a replica; writes
    go to the primary, and a follower that lags the serving version is
    skipped (never stale).

``ShardedHoneycombStore(shards=1)`` is operation-for-operation
``HoneycombStore``, and ``replicas=1`` is the unreplicated store.  Every
snapshot lives on ``device`` (``"cuda"`` unless the caller asks for the
CPU; without a card it raises, like ``HoneycombStore``), in the layout
``cfg.layout`` names, which every shard and follower shares.
``routing()`` gives the service front end (core/api.py) its wiring.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Sequence

import torch

from .api import Routing
from .btree import TreeStats
from .config import HoneycombConfig, ReplicationConfig, ShardingConfig
from .keys import int_key
from .pipeline import PipelineStats
from .replica import ReplicaGroup
from .shard import StoreShard, SyncStats
from .telemetry import merge_stats


def uniform_int_boundaries(n_items: int, shards: int,
                           width: int = 8) -> tuple[bytes, ...]:
    """Split points that spread ``int_key(0..n_items)`` evenly over
    ``shards`` ranges (benchmarks' default partitioning)."""
    return tuple(int_key(n_items * i // shards, width)
                 for i in range(1, shards))


# THE aggregation helper lives beside the collect() protocol it feeds
# (core/telemetry.py merge_stats); this name is the reference's import path
aggregate_stats = merge_stats


class ShardedHoneycombStore:
    """Range-sharded store: N independent ``StoreShard``s behind one
    facade, requests pre-partitioned by a router."""

    def __init__(self, cfg: HoneycombConfig | None = None,
                 heap_capacity: int = 1024,
                 shards: int | ShardingConfig = 1,
                 boundaries: Sequence[bytes] | None = None,
                 replication: ReplicationConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or HoneycombConfig()
        if isinstance(shards, ShardingConfig):
            sharding = shards
        else:
            sharding = ShardingConfig(
                shards=shards,
                boundaries=tuple(boundaries) if boundaries is not None
                else None)
        self.sharding = sharding
        self.replication = replication or ReplicationConfig()
        n = sharding.shards
        if sharding.boundaries is not None:
            self.boundaries = list(sharding.boundaries)
        else:  # uniform split of the 8-byte integer keyspace
            self.boundaries = list(uniform_int_boundaries(2 ** 64, n))
        # every shard slot is a ReplicaGroup (pure primary delegation when
        # replicas=1 — the tested op-for-op equivalence): one primary
        # StoreShard plus the configured follower replicas
        self.shards = [
            ReplicaGroup(StoreShard(self.cfg, heap_capacity, shard_id=i,
                                    device=device),
                         self.replication)
            for i in range(n)]
        self.shard_ops = [0] * n    # routed requests per shard (imbalance)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    # ------------------------------------------------------------- routing
    def shard_for_key(self, key: bytes) -> int:
        """Owning shard: i such that boundaries[i-1] <= key < boundaries[i]."""
        return bisect.bisect_right(self.boundaries, key)

    def _shard_span(self, lo: bytes, hi: bytes) -> tuple[int, int]:
        s_lo = self.shard_for_key(lo)
        return s_lo, max(s_lo, self.shard_for_key(hi))

    def _sub_lo(self, s: int, s_lo: int, lo: bytes) -> bytes:
        """Sub-range start for shard s of a scan beginning at lo: the scan's
        own lo on the owning shard, the shard's lower boundary after it (the
        boundary key itself belongs to the shard, so per-shard floor-start
        returns exactly the keys in [boundary, hi])."""
        return lo if s == s_lo else self.boundaries[s - 1]

    def replica_for_dispatch(self, shard: int) -> int:
        """Read-spreading policy pick for ``shard``'s next read batch —
        delegated to the shard's ``ReplicaGroup`` (the cursor/assignment
        state is per group, so a batch spanning N shards rotates EVERY
        shard's assignment instead of freezing on cursor parity).  The pick
        is a ROUTING decision only; the group still enforces the freshness
        rule at dispatch (a lagging follower is skipped, never stale)."""
        return self.shards[shard].replica_for_dispatch()

    def routing(self) -> Routing:
        """The routed-store wiring for the service/scheduler (core/api.py):
        range ownership, per-shard replica spreading, and read-response
        stamps from the serving group's latest dispatch."""
        return Routing(
            shard_of=self.shard_for_key,
            replica_of=self.replica_for_dispatch,
            report=lambda shard: self.shards[shard].last_dispatch,
            live_version=lambda shard: int(
                self.shards[shard].tree.versions.read_version()))

    # ------------------------------------------------------------- writes
    def put(self, key: bytes, value: bytes, thread: int = 0):
        s = self.shard_for_key(key)
        self.shard_ops[s] += 1
        self.shards[s].put(key, value, thread)

    def update(self, key: bytes, value: bytes, thread: int = 0):
        s = self.shard_for_key(key)
        self.shard_ops[s] += 1
        self.shards[s].update(key, value, thread)

    def delete(self, key: bytes, thread: int = 0):
        s = self.shard_for_key(key)
        self.shard_ops[s] += 1
        self.shards[s].delete(key, thread)

    @contextlib.contextmanager
    def deferred_sync(self):
        """Suspend every shard's automatic policy syncs for a write burst
        the caller closes with one export."""
        with contextlib.ExitStack() as stack:
            for sh in self.shards:
                stack.enter_context(sh.deferred_sync())
            yield

    # ---------------------------------------------------- host-side reads
    def get(self, key: bytes) -> bytes | None:
        s = self.shard_for_key(key)
        self.shard_ops[s] += 1
        return self.shards[s].get(key)

    def scan(self, lo: bytes, hi: bytes,
             max_items: int | None = None) -> list[tuple[bytes, bytes]]:
        """Host-side cross-shard SCAN: per-shard sub-scans stitched in key
        order, global floor back-filled from the left when needed."""
        s_lo, s_hi = self._shard_span(lo, hi)
        items: list[tuple[bytes, bytes]] = []
        for s in range(s_lo, s_hi + 1):
            self.shard_ops[s] += 1
            items.extend(self.shards[s].scan(
                self._sub_lo(s, s_lo, lo), hi, max_items))
            if max_items and len(items) >= max_items:
                break
        if lo <= hi and s_lo > 0 and not (items and items[0][0] <= lo):
            for s in range(s_lo - 1, -1, -1):    # nearest non-empty left shard
                self.shard_ops[s] += 1
                floor = self.shards[s].scan(lo, lo)
                if floor:
                    items = floor + items
                    break
        return items[:max_items] if max_items else items

    # ------------------------------------------------- snapshot mechanics
    def export_snapshot(self, force: bool = False, full: bool = False):
        """Sync every DIRTY shard (clean shards return their resident
        snapshot untouched — per-shard delta independence).  Returns the
        per-shard snapshot list."""
        return [sh.export_snapshot(force=force, full=full)
                for sh in self.shards]

    def begin_export(self, force: bool = False,
                     full: bool = False) -> list[int]:
        """Pipelined sync, staging half: enqueue every DIRTY shard's delta
        scatter into its standby buffer (asynchronous — active snapshots
        keep answering untouched).  Returns the staged shard ids."""
        return [i for i, sh in enumerate(self.shards)
                if sh.begin_export(force=force, full=full)]

    def flip(self):
        """Pipelined sync, publish half: flip every shard with a staged
        standby — each shard advances its epoch INDEPENDENTLY (a clean
        shard's active snapshot and epoch are untouched).  Returns the
        per-shard snapshot list."""
        return [sh.flip() for sh in self.shards]

    # ------------------------------------------------- accelerated reads
    def _pick(self, s: int, replica: int | None) -> int:
        """Replica for one per-shard sub-dispatch: the caller's pin or a
        fresh policy pick."""
        return replica if replica is not None else self.replica_for_dispatch(s)

    def get_batch(self, keys: Sequence[bytes],
                  replica: int | None = None) -> list[bytes | None]:
        """Batched GET: split by owning shard, one dense device batch per
        shard — each pinned to a replica by the read-spreading policy (or
        the caller's explicit pin) — responses scattered back to arrival
        order."""
        keys = list(keys)
        out: list[bytes | None] = [None] * len(keys)
        by_shard: dict[int, list[int]] = {}
        for i, k in enumerate(keys):
            by_shard.setdefault(self.shard_for_key(k), []).append(i)
        for s, idxs in sorted(by_shard.items()):
            self.shard_ops[s] += len(idxs)
            res = self.shards[s].get_batch([keys[i] for i in idxs],
                                           replica=self._pick(s, replica))
            for i, v in zip(idxs, res):
                out[i] = v
        return out

    def scan_batch(self, ranges: Sequence[tuple[bytes, bytes]],
                   replica: int | None = None
                   ) -> list[list[tuple[bytes, bytes]]]:
        """Batched SCAN: decompose each range into per-shard sub-ranges,
        dispatch one dense batch per shard (replica-pinned like get_batch),
        stitch per request in key order (shard order IS key order), then
        back-fill missing global floors."""
        ranges = list(ranges)
        if not ranges:
            return []
        spans = [self._shard_span(lo, hi) for lo, hi in ranges]
        per_shard: dict[int, list[tuple[int, bytes, bytes]]] = {}
        for i, (lo, hi) in enumerate(ranges):
            s_lo, s_hi = spans[i]
            for s in range(s_lo, s_hi + 1):
                per_shard.setdefault(s, []).append(
                    (i, self._sub_lo(s, s_lo, lo), hi))
        parts: dict[int, list[list[tuple[bytes, bytes]]]] = {
            i: [] for i in range(len(ranges))}
        for s, subs in sorted(per_shard.items()):
            self.shard_ops[s] += len(subs)
            res = self.shards[s].scan_batch([(a, b) for _, a, b in subs],
                                            replica=self._pick(s, replica))
            for (i, _, _), sub_items in zip(subs, res):
                parts[i].append(sub_items)   # shards visited in key order
        out = [[kv for chunk in parts[i] for kv in chunk]
               for i in range(len(ranges))]
        # floor back-fill: requests whose owning shard held no key <= lo
        pending = [(i, spans[i][0] - 1, lo)
                   for i, (lo, hi) in enumerate(ranges)
                   if spans[i][0] > 0 and lo <= hi
                   and not (out[i] and out[i][0][0] <= lo)]
        while pending:
            probe: dict[int, list[tuple[int, bytes]]] = {}
            for i, s, lo in pending:
                probe.setdefault(s, []).append((i, lo))
            pending = []
            for s, reqs in sorted(probe.items()):
                self.shard_ops[s] += len(reqs)
                res = self.shards[s].scan_batch(
                    [(lo, lo) for _, lo in reqs],
                    replica=self._pick(s, replica))
                for (i, lo), floor in zip(reqs, res):
                    if floor:
                        out[i] = floor + out[i]
                    elif s > 0:
                        pending.append((i, s - 1, lo))
        return out

    # ------------------------------------------------------------- meters
    @property
    def sync_stats(self) -> SyncStats:
        """Aggregate SyncStats across shards (counters sum; delta_fraction
        reports the worst shard)."""
        return aggregate_stats((sh.sync_stats for sh in self.shards),
                               SyncStats)

    @property
    def per_shard_sync_stats(self) -> list[SyncStats]:
        return [sh.sync_stats for sh in self.shards]

    @property
    def pipeline_stats(self) -> PipelineStats:
        """Aggregate per-stage pipeline meters across shards (staging wall
        time, staged exports, flips)."""
        return aggregate_stats((sh.pipeline_stats for sh in self.shards),
                               PipelineStats)

    @property
    def per_shard_epochs(self) -> list[int]:
        """Snapshot epoch (flip count) per shard — dirty shards advance
        independently."""
        return [sh.epoch for sh in self.shards]

    @property
    def stats(self) -> TreeStats:
        """Aggregate tree stats across shards."""
        return aggregate_stats((sh.stats for sh in self.shards), TreeStats)

    @property
    def per_shard_stats(self) -> list[TreeStats]:
        return [sh.stats for sh in self.shards]

    @property
    def cache_stats(self):
        """Aggregate interior-cache meters across shards (a replicated
        shard's group reaches its primary's cache through the
        fallthrough; follower-served fused batches are already folded in
        by the dispatching shard — see ``StoreShard._note_read_meters``)."""
        from .cache import CacheStats
        return aggregate_stats((sh.cache_stats for sh in self.shards),
                               CacheStats)

    # ------------------------------------------------ replication meters
    @property
    def replication_stats(self) -> SyncStats:
        """Aggregate follower SyncStats across every shard's replica group
        — the delta-feed amplification on top of the primary sync traffic."""
        return aggregate_stats((sh.replication_stats for sh in self.shards),
                               SyncStats)

    @property
    def replication_bytes(self) -> int:
        """Total bytes the follower delta feed moved (replica-amplification
        traffic; 0 when replicas=1)."""
        return sum(sh.replication_bytes for sh in self.shards)

    @property
    def feed_stats(self):
        """Aggregate replication-transport meters (``replica.FeedStats``)
        across every shard's replica group: feed bytes split by edge class
        (primary egress vs relay hops), epochs split by feed kind (log /
        fallback / delta / full), and catch-up traffic."""
        from .replica import FeedStats
        return aggregate_stats((sh.feed_stats for sh in self.shards),
                               FeedStats)

    @property
    def feed_bytes(self) -> int:
        """Total bytes over all replication feed edges (the per-follower
        transport the log feed shrinks to O(log_wire_bytes))."""
        return sum(sh.feed_stats.feed_bytes for sh in self.shards)

    @property
    def relay_hop_bytes(self) -> int:
        """Feed bytes carried by relay->child edges (0 on the flat feed)."""
        return sum(sh.feed_stats.relay_hop_bytes for sh in self.shards)

    @property
    def primary_egress_bytes(self) -> int:
        """Feed bytes leaving the primaries themselves — what the relay
        tree bounds at O(fanout) instead of O(replicas)."""
        return sum(sh.feed_stats.primary_egress_bytes for sh in self.shards)

    @property
    def log_fallback_epochs(self) -> int:
        """Log-feed stagings that shipped the image delta because the
        epoch was not replayable (tree shape changed / GC / overflow)."""
        return sum(sh.feed_stats.log_fallback_epochs for sh in self.shards)

    @property
    def replica_lag_epochs(self) -> list[list[int]]:
        """Per shard, each follower's epoch lag behind its primary."""
        return [sh.replica_lag_epochs for sh in self.shards]

    @property
    def replica_staleness(self) -> list[list[int]]:
        """Per shard, each follower's read-version staleness."""
        return [sh.replica_staleness for sh in self.shards]

    @property
    def per_shard_replica_ops(self) -> list[list[int]]:
        """Requests served per replica (primary first), per shard — the
        read-spread twin of ``shard_ops``."""
        return [list(sh.replica_ops) for sh in self.shards]

    @property
    def lagging_skips(self) -> int:
        """Read batches redirected off a stale follower (freshness rule)."""
        return sum(sh.lagging_skips for sh in self.shards)

    @property
    def replica_load_imbalance(self) -> float:
        """max/mean requests served per replica lane across the whole store
        (1.0 = perfectly spread; 0.0 = no device traffic yet)."""
        ops = [o for sh in self.shards for o in sh.replica_ops]
        total = sum(ops)
        if not total:
            return 0.0
        return max(ops) / (total / len(ops))

    @property
    def load_imbalance(self) -> float:
        """max/mean routed requests per shard (1.0 = perfectly balanced,
        0.0 = no traffic yet)."""
        total = sum(self.shard_ops)
        if not total:
            return 0.0
        return max(self.shard_ops) / (total / len(self.shard_ops))

    # ------------------------------------------------------------- misc
    def collect_garbage(self) -> int:
        return sum(sh.collect_garbage() for sh in self.shards)

    def check_invariants(self):
        for sh in self.shards:
            sh.tree.check_invariants()
