"""Replication — follower replicas fed by the primary's staged syncs (port
of ``repro.core.replica``).

Each range-shard can serve reads from MORE THAN ONE device image: reads
scale with device lanes while writes stay on the host CPU (paper Sections
3.4/5).  A follower is a device-resident copy of its primary's snapshot
with no tree of its own, fed only by the primary's ``StagedSync``
payloads (core/shard.py):

  * under the LOG feed (``ReplicationConfig.feed="log"``, the default) a
    replayable delta epoch ships its ``LogPayload`` — the epoch's writes
    wire-encoded ONCE by the core/api.py codec plus a placement sidecar —
    and each follower replays it with the ``log_replay_scatter`` kernel
    (``kernels/csrc/log_replay.cu`` on CUDA): every entry's ~(key_words +
    val_words + 6) words land in the follower's packed image at static
    ``NodeImageLayout`` offsets, instead of a whole image row per dirty
    node;
  * an epoch whose tree shape changed (split/merge, GC, pending page-table
    commands, an overflow-length value) has no wire-replay form and falls
    back per-epoch to the image-row delta, metered as
    ``FeedStats.log_fallback_epochs``; ``feed="delta"`` ships the image
    delta every epoch, and so does the legacy per-field layout, which has
    no packed image to replay into: a legacy follower applies the
    primary's ``LegacySnapshotDelta`` to a clone of its fields with the
    same one-launch multi-field scatter the primary used;
  * a "full" payload (first export, heap growth, dirty fraction over the
    threshold) copies the primary's staged standby;
  * a follower that missed a payload (paused, or cut off behind a paused
    relay) is OUT OF SYNC and catches up with a full copy at the next
    reachable staging (or ``resync_follower``); until then the freshness
    rule never serves it.

**Relay tree** (``FeedTopology(fanout, depth)``, core/config.py): with
``depth >= 1`` the one encoded payload routes primary -> up to ``fanout``
relays -> their children, so the primary's egress
(``FeedStats.primary_egress_bytes``) is O(fanout) and downstream edges
are metered as ``relay_hop_bytes``.  A paused relay cuts off its subtree.

**ReplicaGroup** — one primary ``StoreShard`` plus N-1 followers behind
the shard facade (attribute access falls through to the primary).  It
wires the primary's ``on_staged``/``on_flip`` hooks, so whatever triggers
a staging feeds the whole group.  Read batches go to the replica the
read-spreading policy picks (primary_only / round_robin / least_loaded);
a follower whose published read version lags the primary's active
snapshot is skipped (``lagging_skips``) and the batch serves from the
primary, so spread reads are never stale.  ``replicas=1`` is op-for-op
the unreplicated store: no followers, no capture, hooks that do nothing.
``routing()`` gives the service front end (core/api.py) its wiring.

Device memory: every follower keeps its own active image on the shard's
device.  Like the delta apply (``read_path.apply_snapshot_delta``), a log
replay clones the follower's whole image (S·IW·4 bytes) and replays into
the clone in place, so the active snapshot keeps answering while the
standby is staged.

The EpochSan seams (``analysis/epochsan.py``) sit where the reference's
do: ``stage``/``stage_log`` tag the follower's standby, its ``flip`` the
published snapshot, and ``get_batch``/``scan_batch`` re-derive the
freshness rule before a batch dispatches to a follower.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..analysis import epochsan as _epochsan
from ..kernels import ops as kernel_ops
from .api import Routing, decode_wire_stream
from .config import ReplicationConfig, bucket_pow2
from .heap import LOG_DELETE, LOG_INSERT, LOG_UPDATE
from .read_path import (NODE_FIELDS, TreeSnapshot, apply_snapshot_delta,
                        attach_cache_image)
from .schema import NodeImageLayout
from .shard import LogPayload, StagedSync, StoreShard, SyncStats
from .telemetry import CLOCK, merge_stats, samples_from

_now = CLOCK            # THE injectable monotonic clock (core/telemetry.py)

# wire op kind -> heap log op code (the decode half of the feed)
_LOG_CODES = {"put": LOG_INSERT, "update": LOG_UPDATE, "delete": LOG_DELETE}


@dataclasses.dataclass
class FeedStats:
    """Transport meters of one ReplicaGroup's replication feed (summed
    across shards by ``router.aggregate_stats``).  Byte counters meter
    EDGES (one increment per follower delivery); epoch counters meter
    STAGINGS (one increment per ``begin_export`` that fed followers)."""
    feed_bytes: int = 0           # total bytes over all feed edges
    wire_bytes: int = 0           # exact op wire stream bytes shipped
    log_bytes: int = 0            # edge bytes of log-replay deliveries
    fallback_bytes: int = 0       # edge bytes of image deltas shipped on
    #   fallback epochs (log feed only; the fallback-fraction numerator)
    primary_egress_bytes: int = 0  # bytes on primary->child edges — the
    #   feeder bandwidth the relay tree bounds at O(fanout)
    relay_hop_bytes: int = 0      # bytes on relay->child edges
    log_feed_epochs: int = 0      # stagings shipped as a log payload
    log_fallback_epochs: int = 0  # log-feed stagings that had to ship the
    #   image delta (tree shape changed / GC / overflow value)
    delta_feed_epochs: int = 0    # stagings shipped as deltas by choice
    #   (feed="delta", or the legacy layout with no packed image to replay
    #   into)
    full_feed_epochs: int = 0     # full-publish stagings
    full_catchups: int = 0        # out-of-sync followers refed a full copy
    catchup_bytes: int = 0        # bytes those full catch-ups moved

    def collect(self):
        """Registry samples: ``replication_*`` counters for every
        feed-transport meter."""
        return samples_from(self, "replication", "replica")


def _snapshot_nbytes(snap) -> int:
    """Bytes of a whole snapshot as the reference meters them: every
    tensor field plus the two sync scalars, which the reference keeps as
    0-d int32 device arrays (4 B each) and the port as Python ints."""
    return 8 + sum(x.nbytes for x in snap if isinstance(x, torch.Tensor))


def _image_feed_cost(snap) -> tuple[int, int]:
    """(copies, node-image bytes) of device-copying a whole snapshot into
    a follower: the packed layout moves ONE contiguous image; legacy moves
    one tensor per field — same bytes."""
    if isinstance(snap, TreeSnapshot):
        return 1, snap.image.nbytes
    return len(NODE_FIELDS), sum(getattr(snap, f).nbytes
                                 for f in NODE_FIELDS)


def _copy_snapshot(snap):
    """A snapshot whose tensors are fresh copies (no storage shared with
    ``snap``)."""
    return snap._replace(**{f: v.clone() for f, v in snap._asdict().items()
                            if isinstance(v, torch.Tensor)})


class FollowerReplica:
    """One follower's device-resident state: its own active/standby
    snapshots, SyncStats, and epoch/read-version watermark.  Fed only by
    the primary's ``StagedSync`` payloads; never written directly."""

    def __init__(self, replica_id: int, in_sync: bool = True, cfg=None):
        self.replica_id = replica_id
        self.cfg = cfg                 # layout schema for cache re-attach
        self.sync_stats = SyncStats()
        self.epoch = 0                 # primary epoch at our last publish
        self.paused = False            # fault injection / maintenance
        # True iff our scatter base equals the primary's scatter base, i.e.
        # we applied every payload since the last full copy — only then may
        # a delta or log payload be replayed here
        self.in_sync = in_sync
        self.snapshot: TreeSnapshot | None = None
        self.snapshot_rv: int | None = None
        self._standby: TreeSnapshot | None = None
        self._standby_rv: int | None = None
        self.served_ops = 0

    def stage(self, payload: StagedSync) -> tuple[int, bool]:
        """Replay one primary staging into our standby: re-apply the delta
        scatter on our own base when in sync, otherwise copy the primary's
        staged standby (full catch-up).  Returns the bytes this delivery
        moved over our feed edge and whether it was full."""
        base = self._standby if self._standby is not None else self.snapshot
        stats = self.sync_stats
        stats.snapshots += 1
        if payload.kind == "delta" and self.in_sync and base is not None:
            # our own clone + scatter (the row-scatter kernel on CUDA, or
            # the multi-field one for a legacy delta): O(dirty_rows)
            # traffic over the feed edge
            self._standby = apply_snapshot_delta(base, payload.delta,
                                                 cfg=self.cfg)
            stats.delta_syncs += 1
            stats.delta_rows += payload.delta_rows
            stats.bytes_synced += payload.nbytes
            stats.image_dma_count += payload.image_dmas
            stats.image_bytes += payload.image_bytes
            nbytes, was_full = payload.nbytes, False
        else:
            # full feed: first publish, primary full republish, or catch-up
            # after a missed payload (a delta would land on the wrong base)
            self._standby = _copy_snapshot(payload.snapshot)
            stats.full_syncs += 1
            nbytes = (payload.nbytes if payload.kind == "full"
                      else _snapshot_nbytes(payload.snapshot))
            stats.bytes_synced += nbytes
            dmas, ibytes = _image_feed_cost(payload.snapshot)
            stats.image_dma_count += dmas
            stats.image_bytes += ibytes
            self.in_sync = True
            was_full = True
        self._standby_rv = payload.read_version
        san = _epochsan.get()
        if san is not None:
            san.note_staged(self, self._standby)
        return nbytes, was_full

    def stage_log(self, payload: StagedSync, marshalled) -> int:
        """Replay one staging from its LOG payload: clone our base image
        and scatter the epoch's marshalled wire entries into the clone with
        ``log_replay_scatter`` — O(entry words) of writes, no image rows
        moved (``image_dma_count``/``image_bytes`` stay put).  By induction
        our base equals the primary's scatter base, so the replayed standby
        is bit-identical to the primary's staged standby.  Only callable in
        sync with an existing base; returns edge bytes."""
        lp = payload.log_payload
        base = self._standby if self._standby is not None else self.snapshot
        stats = self.sync_stats
        stats.snapshots += 1
        if marshalled is None:           # forced epoch with zero writes:
            image = base.image           # only the read version advances
        else:
            rows, slots, entries, offs = marshalled
            # the active snapshot keeps answering: replay into a copy
            image = base.image.clone()
            kernel_ops.log_replay_scatter(image, rows, slots, entries,
                                          offs=offs)
        snap = base._replace(image=image, read_version=lp.read_version)
        if self.cfg is not None:
            # replayable epochs keep the tree shape, so the base's cache
            # frontier stays valid; only the cached rows are re-gathered
            snap = attach_cache_image(snap, self.cfg)
        self._standby = snap
        self._standby_rv = payload.read_version
        stats.log_replays += 1
        stats.log_entries += lp.entries
        stats.log_wire_bytes += lp.wire_nbytes
        stats.bytes_synced += lp.nbytes
        san = _epochsan.get()
        if san is not None:
            san.note_staged(self, self._standby)
        return lp.nbytes

    def flip(self, primary_epoch: int) -> bool:
        """Publish the staged standby; no-op when nothing is staged (the
        follower keeps lagging and the router keeps skipping it)."""
        if self._standby is None:
            return False
        self.snapshot = self._standby
        self.snapshot_rv = self._standby_rv
        self._standby = None
        self._standby_rv = None
        self.epoch = primary_epoch
        san = _epochsan.get()
        if san is not None:
            san.note_flip(self, self.snapshot)
        return True


class ReplicaGroup:
    """One primary ``StoreShard`` plus N-1 ``FollowerReplica``s behind the
    shard facade.  Writes and host reads hit the primary (attribute
    fallthrough); device read batches can be pinned to any FRESH replica;
    every sync staging/flip feeds the whole group."""

    def __init__(self, primary: StoreShard,
                 replication: ReplicationConfig | None = None):
        self.primary = primary
        self.replication = replication or ReplicationConfig()
        fresh = (primary._snapshot is None and primary._standby is None)
        self.followers = [FollowerReplica(i + 1, in_sync=fresh,
                                          cfg=primary.cfg)
                          for i in range(self.replication.replicas - 1)]
        self.lagging_skips = 0         # batches redirected off a stale follower
        self.replication_s = 0.0       # wall time spent feeding followers
        self.feed_stats = FeedStats()
        # relay tree: follower id -> feeding parent id (0 = primary); ids
        # ascend level by level, so walking followers in order always
        # visits a parent before its children
        self._parents = self.replication.topology.parents(len(self.followers))
        # the log feed needs the packed image (the replay kernel's one
        # destination); the legacy per-field layout keeps the delta feed.
        # Capture costs the unreplicated store nothing: the flag stays
        # False with no followers.
        self._log_enabled = (self.replication.feed == "log"
                             and bool(self.followers)
                             and primary.cfg.layout == "packed")
        primary.log_capture = self._log_enabled
        self._primary_served = 0       # device requests the primary served
        # read-spreading policy state: round_robin cursor, and
        # least_loaded's pick-time assignment counts
        self._rr = 0
        self._assigned = [0] * self.replication.replicas
        # (replica_served, serving_version) of the latest device batch
        self.last_dispatch: tuple[int, int] = (0, 0)
        primary.on_staged = self._on_primary_staged
        primary.on_flip = self._on_primary_flip
        if not fresh and self.followers and primary._snapshot is not None:
            for f in self.followers:   # late attach: full-copy the active
                f.stage(StagedSync("full", primary._snapshot, None,
                                   _snapshot_nbytes(primary._snapshot), 0,
                                   primary._snapshot_rv))
                f.flip(primary.epoch)
                f.in_sync = primary._standby is None

    def __getattr__(self, name: str):
        # facade fallthrough: anything not replica-specific is the primary's
        if name == "primary" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.primary, name)

    @property
    def n_replicas(self) -> int:
        return 1 + len(self.followers)

    # --------------------------------------------------- replication feed
    def _marshal_log_payload(self, lp: LogPayload):
        """Decode the one encoded wire stream and marshal it into the
        dense device block ``log_replay_scatter`` consumes — ONCE per
        staging, shared by every follower lane (each lane still runs its
        own replay).  Entries pad to the shared pow2 bucket schedule with
        repeats of the last record."""
        if lp.entries == 0:
            return None
        layout = NodeImageLayout.for_config(self.primary.cfg)
        ops = decode_wire_stream(lp.wire)
        blk = layout.pack_log_entries(
            ops, [_LOG_CODES[op.KIND] for op in ops],
            lp.backptrs, lp.hints, lp.vdeltas)
        size = bucket_pow2(lp.entries)
        rows = StoreShard._pad_index(lp.rows, size)
        slots = StoreShard._pad_index(lp.slots, size)
        if size > lp.entries:
            blk = np.concatenate(
                [blk, np.repeat(blk[-1:], size - lp.entries, axis=0)])
        dev = self.primary._dev
        return dev(rows), dev(slots), dev(blk), layout.log_replay_offsets()

    def _on_primary_staged(self, payload: StagedSync) -> None:
        """Feed one staging to the group through the relay tree: marshal
        the log payload's device block once, then deliver parent-first — a
        follower whose parent is paused or itself undelivered misses the
        payload (out of sync until a reachable staging full-copies it).
        Every edge's bytes are metered into ``FeedStats`` by edge class."""
        t0 = _now()
        fs = self.feed_stats
        lp = payload.log_payload
        marshalled = None
        if self.followers:
            if payload.kind == "full":
                fs.full_feed_epochs += 1
            elif lp is not None:
                fs.log_feed_epochs += 1
                marshalled = self._marshal_log_payload(lp)
            elif self._log_enabled:
                fs.log_fallback_epochs += 1
            else:
                fs.delta_feed_epochs += 1
        delivered = {0}
        for f in self.followers:
            parent = self._parents.get(f.replica_id, 0)
            if f.paused or parent not in delivered:
                f.in_sync = False      # missed payload: next feed is full
                continue
            can_replay = (lp is not None and f.in_sync
                          and (f._standby is not None
                               or f.snapshot is not None))
            if can_replay:
                nbytes = f.stage_log(payload, marshalled)
                fs.wire_bytes += lp.wire_nbytes
                fs.log_bytes += nbytes
            else:
                nbytes, was_full = f.stage(payload)
                if was_full and payload.kind != "full":
                    fs.full_catchups += 1
                    fs.catchup_bytes += nbytes
                elif self._log_enabled and payload.kind == "delta":
                    fs.fallback_bytes += nbytes
            fs.feed_bytes += nbytes
            if parent == 0:
                fs.primary_egress_bytes += nbytes
            else:
                fs.relay_hop_bytes += nbytes
            delivered.add(f.replica_id)
        self.replication_s += _now() - t0

    def _on_primary_flip(self) -> None:
        """Publish the group: every follower with a staged standby flips to
        the primary's new epoch; paused followers fall behind.  A follower
        that missed an intermediate staging (in_sync False) must NOT
        publish its older standby under the new epoch, so it also waits
        for the full catch-up feed."""
        for f in self.followers:
            if not f.paused and f.in_sync:
                f.flip(self.primary.epoch)

    # ------------------------------------------------- fault injection /
    # lag control (tests, maintenance drains)
    def pause_follower(self, replica: int) -> None:
        self.followers[replica - 1].paused = True

    def resume_follower(self, replica: int) -> None:
        self.followers[replica - 1].paused = False

    def resync_follower(self, replica: int) -> None:
        """Immediate full catch-up from the primary's ACTIVE snapshot
        (metered as a full sync); the follower serves again right away."""
        f = self.followers[replica - 1]
        snap = self.primary._snapshot
        if snap is None:
            return
        f.snapshot = _copy_snapshot(snap)
        f.snapshot_rv = self.primary._snapshot_rv
        f._standby = None
        f._standby_rv = None
        f.epoch = self.primary.epoch
        # deltas only resume if the primary has nothing staged mid-air
        # (an unflipped standby is a base we did not copy)
        f.in_sync = self.primary._standby is None
        f.sync_stats.snapshots += 1
        f.sync_stats.full_syncs += 1
        nbytes = _snapshot_nbytes(snap)
        f.sync_stats.bytes_synced += nbytes
        dmas, ibytes = _image_feed_cost(snap)
        f.sync_stats.image_dma_count += dmas
        f.sync_stats.image_bytes += ibytes
        # an admin resync is a primary-direct full catch-up on the feed
        self.feed_stats.full_catchups += 1
        self.feed_stats.catchup_bytes += nbytes
        self.feed_stats.feed_bytes += nbytes
        self.feed_stats.primary_egress_bytes += nbytes

    # ------------------------------------------------- replica dispatch
    def replica_for_dispatch(self) -> int:
        """Read-spreading policy pick for the next read batch —
        ``primary_only`` always serves the primary, ``round_robin`` rotates
        over the currently ELIGIBLE replicas, ``least_loaded`` picks the
        eligible replica with the fewest pick-time assignments.  Dispatch
        still enforces the freshness rule."""
        if (self.replication.policy == "primary_only"
                or self.n_replicas == 1):
            return 0
        elig = self.eligible_replicas()        # always contains the primary
        if self.replication.policy == "round_robin":
            r = elig[self._rr % len(elig)]
            self._rr += 1
            return r
        r = min(elig, key=self._assigned.__getitem__)
        self._assigned[r] += 1
        return r

    def routing(self) -> Routing:
        """Single-shard replicated wiring for the service (core/api.py):
        shard 0 everywhere, the group's own read-spreading pick, reads
        stamped with the serving replica + its snapshot read version."""
        return Routing(
            shard_of=lambda key: 0,
            replica_of=((lambda shard: self.replica_for_dispatch())
                        if self.n_replicas > 1 else None),
            report=lambda shard: self.last_dispatch,
            live_version=lambda shard: int(
                self.primary.tree.versions.read_version()))

    def eligible_replicas(self) -> list[int]:
        """Replica indices a read batch may be pinned to right now: the
        primary always, plus every follower that is unpaused and whose
        published read version covers the serving version."""
        return [0] + [i for i, f in enumerate(self.followers, start=1)
                      if not f.paused and self._covers(f)]

    def _covers(self, f: FollowerReplica) -> bool:
        """Freshness rule: the follower's published read version must cover
        what the group currently serves (the primary's active snapshot read
        version) — otherwise a spread read could observe stale state."""
        need = self.primary._snapshot_rv
        return (f.snapshot is not None and need is not None
                and f.snapshot_rv is not None and f.snapshot_rv >= need)

    def _serving_follower(self, replica: int | None,
                          n: int) -> FollowerReplica | None:
        """Resolve a dispatch to a follower, or None for the primary —
        enforcing the freshness rule (a lagging follower is skipped, the
        batch serves from the primary, and the skip is metered)."""
        if not replica or not self.followers:
            self._primary_served += n
            return None
        if self.primary.cfg.sync_policy != "explicit":
            # lazy-sync policies: freshen the whole group first, exactly as
            # the primary's own read path would (no-op when clean)
            self.primary.export_snapshot()
        f = self.followers[(replica - 1) % len(self.followers)]
        if not self._covers(f):
            self.lagging_skips += 1
            self._primary_served += n
            return None
        f.served_ops += n
        return f

    @property
    def replica_ops(self) -> list[int]:
        """Requests served per replica (primary first) — the least_loaded
        policy's signal and the read-spread imbalance meter."""
        return [self._primary_served] + [f.served_ops for f in self.followers]

    def get_batch(self, keys, replica: int | None = None):
        keys = list(keys)
        if not keys:
            return []
        f = self._serving_follower(replica, len(keys))
        if f is None:
            res = self.primary.get_batch(keys)
            self.last_dispatch = (0, self.primary.serving_version)
            return res
        san = _epochsan.get()
        if san is not None:   # re-derive the freshness rule at dispatch
            san.check_follower_dispatch(self, f)
        res = self.primary._device_get(f.snapshot, keys)
        self.last_dispatch = (f.replica_id,
                              f.snapshot_rv if f.snapshot_rv is not None
                              else 0)
        return res

    def scan_batch(self, ranges, replica: int | None = None):
        ranges = list(ranges)
        if not ranges:
            return []
        f = self._serving_follower(replica, len(ranges))
        if f is None:
            res = self.primary.scan_batch(ranges)
            self.last_dispatch = (0, self.primary.serving_version)
            return res
        san = _epochsan.get()
        if san is not None:   # re-derive the freshness rule at dispatch
            san.check_follower_dispatch(self, f)
        # eligibility pinned the follower at the primary snapshot's read
        # version, so truncated-scan host fallbacks use the primary's rule
        res = self.primary._device_scan(f.snapshot, ranges,
                                        self.primary._fallback_read_version())
        self.last_dispatch = (f.replica_id,
                              f.snapshot_rv if f.snapshot_rv is not None
                              else 0)
        return res

    # ------------------------------------------------------------- meters
    @property
    def replica_lag_epochs(self) -> list[int]:
        """Per-follower epoch lag behind the primary (0 = fully caught up)."""
        return [self.primary.epoch - f.epoch for f in self.followers]

    @property
    def replica_staleness(self) -> list[int]:
        """Per-follower read-version lag behind the primary's published
        snapshot (staleness in read-versions, 0 = serving-fresh)."""
        need = self.primary._snapshot_rv
        if need is None:
            return [0] * len(self.followers)
        return [need - (f.snapshot_rv if f.snapshot_rv is not None else 0)
                for f in self.followers]

    @property
    def replication_stats(self) -> SyncStats:
        """Aggregate follower SyncStats — the replication amplification the
        feed generated on top of the primary's own sync traffic."""
        return merge_stats((f.sync_stats for f in self.followers),
                           SyncStats)

    @property
    def replication_bytes(self) -> int:
        return sum(f.sync_stats.bytes_synced for f in self.followers)

    @property
    def per_replica_sync_stats(self) -> list[SyncStats]:
        return ([self.primary.sync_stats]
                + [f.sync_stats for f in self.followers])
