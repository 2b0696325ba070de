"""StoreShard — one device's slice of the store (port of
``repro.core.shard``).

A host B+Tree writer (``HoneycombTree``), the MVCC/epoch machinery, an
interior cache and the device read path, bound to a DOUBLE-BUFFERED
resident device snapshot kept in sync by the incremental delta subsystem:

  * ``begin_export()`` / ``flip()`` — the two halves of the host->device
    synchronization point.  ``begin_export`` *stages*: the first export
    publishes the heap wholesale; afterwards only *dirty node rows* plus
    the batched page-table commands and the read version are scattered
    into the STANDBY snapshot, so sync traffic scales with write
    volume, and in-flight read batches keep answering from the untouched
    active snapshot.  ``flip`` *publishes* the standby (``epoch`` counts
    flips); old-epoch snapshots are separate device tensors and keep
    answering at their pinned read version.
  * ``export_snapshot()`` ≡ ``begin_export(); flip()``.
  * ``cfg.sync_policy`` — when the sync happens: lazily before device reads
    ("on_read"), after every K writes ("every_k"), or only when explicitly
    requested ("explicit", stale-but-consistent reads; an accelerator epoch
    pins the resident snapshot so host fallbacks run at its read version).
  * ``get_batch()/scan_batch()`` — wait-free reads against the snapshot,
    epoch-stamped, padded to power-of-two batch buckets.  With
    ``read_backend="fused"`` one kernel launch serves a batch
    (``kernels/ops.py`` picks the kernel for CUDA tensors and its plain
    version for CPU tensors); SCANs the device truncates fall back to the
    host tree.
  * ``cfg.layout`` — the snapshot's shape on the device.  "packed" (the
    default) is ONE ``[S, image_words]`` image: a full publish is one
    copy and a delta ships one image row per dirty node.  "legacy" keeps
    one tensor per node field: a full publish is 24 copies, a delta ships
    24 ``[D, W_f]`` blocks that ONE multi-field scatter applies, and reads
    go through the per-level ``"reference"`` path, since there is no
    packed image for the fused kernel to walk.

Every snapshot tensor lives on ``device`` (``"cuda"`` unless the caller
asks for the CPU).  Publishing copies host arrays explicitly:
``torch.from_numpy`` aliases numpy memory, and an aliased snapshot would
see later host mutations.

For the log-shipped replication feed (core/replica.py) a replica group
sets ``log_capture``: every write is then captured with its fast-path
placement, and a delta staging whose writes all took the leaf fast path
carries them as one ``LogPayload`` (the op wire stream plus a placement
sidecar) that followers replay on the device.

The EpochSan seams (``analysis/epochsan.py``) sit where the reference's
do: ``begin_export`` tags the staged standby, ``flip`` the published
snapshot, ``_device_get``/``_device_scan`` check the snapshot before any
packing or launch, and ``collect_garbage`` audits each collect against
the pre-collect epoch window.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..analysis import epochsan as _epochsan
from ..kernels import ops as kernel_ops
from .api import OPS_BY_KIND, Delete, Routing, wire_entry_nbytes
from .btree import HoneycombTree
from .cache import InteriorCache
from .config import HoneycombConfig, bucket_pow2
from .keys import pack_keys
from .pipeline import PipelineStats
from .read_path import (NODE_FIELDS, LegacySnapshotDelta, LegacyTreeSnapshot,
                        SnapshotDelta, TreeSnapshot, apply_snapshot_delta,
                        attach_cache_image, batched_get, batched_scan)
from .schema import NARROWED_FIELDS, NodeImageLayout
from .telemetry import CLOCK, samples_from

_now = CLOCK            # THE injectable monotonic clock (core/telemetry.py)


@dataclasses.dataclass
class SyncStats:
    snapshots: int = 0            # exports that refreshed the device image
    full_syncs: int = 0           # wholesale republishes
    delta_syncs: int = 0          # incremental scatters
    bytes_synced: int = 0         # host->device array traffic (both modes)
    pagetable_commands: int = 0   # accumulated PCIe page-table updates
    read_version_updates: int = 0  # accumulated PCIe read-version writes
    delta_rows: int = 0           # dirty node rows scattered (cumulative)
    delta_fraction: float = 0.0   # dirty fraction at the last sync
    log_entries: int = 0          # writes accepted (one log entry each)
    log_wire_bytes: int = 0       # append-only wire-format bytes
    #   (key+value+WIRE_ENTRY_OVERHEAD per write)
    image_dma_count: int = 0      # node-image copies: the packed layout
    #   makes ONE per dirty node on a delta and one per whole image on a
    #   full publish; legacy makes one per field per node (24x)
    image_bytes: int = 0          # node-image payload bytes
    log_replays: int = 0          # follower stagings applied by replaying
    #   the epoch's op wire stream on the device (log_replay_scatter)
    #   instead of re-issuing the primary's image rows

    def merge(self, other: "SyncStats"):
        """Accumulate another shard's counters (aggregation)."""
        for f in dataclasses.fields(self):
            if f.name == "delta_fraction":
                self.delta_fraction = max(self.delta_fraction,
                                          other.delta_fraction)
            else:
                setattr(self, f.name,
                        getattr(self, f.name) + getattr(other, f.name))

    def collect(self):
        """Registry samples: ``sync_*`` counters, ``sync_delta_fraction``
        as a gauge."""
        return samples_from(self, "sync", "shard",
                            gauges=("delta_fraction",))


@dataclasses.dataclass
class StagedSync:
    """One ``begin_export`` staging as it crossed the bus — the unit a
    follower replica replays (core/replica.py).  ``kind`` is "full" or
    "delta"; ``delta`` is the staged ``SnapshotDelta`` or
    ``LegacySnapshotDelta``, matching ``cfg.layout`` (None for full
    publishes); ``snapshot`` is the staged standby, which doubles as the
    catch-up source for followers that fell out of sync; ``nbytes`` the
    metered traffic and ``delta_rows`` the unpadded dirty-row count;
    ``image_dmas``/``image_bytes`` the staging's node-image copies and
    bytes (what each follower delta apply repeats); ``read_version`` is
    what the standby answers at once flipped.  ``log_payload`` is present
    iff log capture is on and the epoch is replayable (every write took
    the leaf fast path: no split/merge/GC/page-table move/overflow value);
    None means followers take the image delta, the metered per-epoch
    fallback."""
    kind: str
    snapshot: TreeSnapshot | LegacyTreeSnapshot
    delta: SnapshotDelta | LegacySnapshotDelta | None
    nbytes: int
    delta_rows: int
    read_version: int
    image_dmas: int = 0
    image_bytes: int = 0
    log_payload: "LogPayload | None" = None


@dataclasses.dataclass
class LogPayload:
    """One sync epoch's writes, encoded ONCE for every follower lane.

    ``wire`` is the op stream in the exact core/api.py wire format
    (``len(wire)`` equals the epoch's ``SyncStats.log_wire_bytes``
    growth).  The sidecar vectors carry each write's fast-path placement —
    physical leaf row, log slot, backptr, order hint, version delta — which
    the primary derived from its pre-epoch tree, so a follower needs no
    host tree and replay is a pure device scatter.  ``nbytes`` is what one
    follower edge moves: wire + sidecar."""
    wire: bytes
    rows: np.ndarray          # [E] int32 physical leaf slot per entry
    slots: np.ndarray         # [E] int32 log slot index per entry
    backptrs: np.ndarray      # [E] int32 sorted-block back pointers
    hints: np.ndarray         # [E] int32 log order hints
    vdeltas: np.ndarray       # [E] int64 version deltas (narrow on device)
    entries: int
    read_version: int
    wire_nbytes: int
    nbytes: int


class StoreShard:
    """One range-shard of the store: its own tree, resident device snapshot,
    incremental delta sync and SyncStats."""

    def __init__(self, cfg: HoneycombConfig | None = None,
                 heap_capacity: int = 1024, shard_id: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or HoneycombConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the store runs on the GPU; pass "
                "device='cpu' to run its plain PyTorch path")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.shard_id = shard_id
        self.tree = HoneycombTree(self.cfg, heap_capacity)
        self.cache = InteriorCache(self.cfg)
        # Section 5: a page-table command for a LID invalidates that LID's
        # cache entry
        self.tree.pt.on_remap = self.cache.invalidate
        self.sync_stats = SyncStats()
        self._snapshot: TreeSnapshot | None = None
        self._snapshot_dirty = True
        self._writes_since_sync = 0
        self._sync_deferred = False
        # counter watermarks so multi-sync runs accumulate (not overwrite)
        self._pt_commands_seen = 0
        self._rv_updates_seen = 0
        # array generations the resident snapshot was published against;
        # growth changes shapes and forces a full republish
        self._heap_gen = -1
        self._pt_gen = -1
        # read version the resident snapshot answers at; under "explicit"
        # an accelerator epoch pins it so GC keeps old buffers alive
        self._snapshot_rv: int | None = None
        self._snapshot_pin: tuple[int, int] | None = None
        # double buffer: begin_export() stages the next epoch into the
        # standby; flip() publishes it
        self.epoch = 0
        self.pipeline_stats = PipelineStats()
        self._standby: TreeSnapshot | None = None
        self._standby_rv: int | None = None
        self._standby_pin: tuple[int, int] | None = None
        # replication hooks: a replica group sets these so every staging
        # and flip feeds its followers; last_staged describes the staged,
        # unflipped standby only
        self.last_staged: StagedSync | None = None
        self.on_staged: Callable[[StagedSync], None] | None = None
        self.on_flip: Callable[[], None] | None = None
        self._staged_delta: SnapshotDelta | None = None
        # log-shipped feed capture (core/replica.py sets log_capture when
        # followers ride the "log" feed; the unreplicated store pays one
        # bool check per write).  The epoch log holds (op, placement) per
        # write since the last staging; any write that missed the leaf
        # fast path — or carried an overflow-length value, or a GC pass —
        # poisons the epoch, and its staging falls back to the image delta.
        self.log_capture = False
        self._epoch_log: list = []
        self._epoch_replayable = True
        self._staged_pt_cmds = 0
        # device SCANs truncated by the leaf/slot budget, answered by the
        # host tree instead
        self.scan_fallbacks = 0

    # ------------------------------------------------------------- writes
    def put(self, key: bytes, value: bytes, thread: int = 0):
        self.tree.put(key, value, thread)
        self._note_write(key, value, "put")

    def update(self, key: bytes, value: bytes, thread: int = 0):
        self.tree.update(key, value, thread)
        self._note_write(key, value, "update")

    def delete(self, key: bytes, thread: int = 0):
        self.tree.delete(key, thread)
        self._note_write(key, b"", "delete")

    def _note_write(self, key: bytes, value: bytes, kind: str = "put"):
        self._snapshot_dirty = True
        self._writes_since_sync += 1
        self.sync_stats.log_entries += 1
        self.sync_stats.log_wire_bytes += wire_entry_nbytes(key, value)
        if self.log_capture:
            # capture BEFORE any policy auto-sync below, so the staging
            # that this very write triggers still carries it
            self._capture_op(key, value, kind)
        if (self.cfg.sync_policy == "every_k"
                and self._writes_since_sync >= self.cfg.sync_every_k
                and not self._sync_deferred):
            self.export_snapshot()

    def _capture_op(self, key: bytes, value: bytes, kind: str):
        """Append this write to the epoch log for the log-shipped feed.
        A write that missed the fast path (split/merge/underflow — the
        tree shape changed) or stored an overflow-length value (the
        overflow slot id is not derivable from the wire value) poisons
        the epoch: its staging ships the image delta instead."""
        placement = self.tree.last_placement
        if placement is None or len(value) > self.cfg.max_inline_val_bytes:
            self._epoch_replayable = False
            self._epoch_log.clear()
            return
        if self._epoch_replayable:
            op = Delete(key) if kind == "delete" \
                else OPS_BY_KIND[kind](key, value)
            self._epoch_log.append((op, placement))

    @contextlib.contextmanager
    def deferred_sync(self):
        """Suspend automatic policy syncs ("every_k") for a write burst the
        caller will close with ONE batched sync."""
        self._sync_deferred = True
        try:
            yield
        finally:
            self._sync_deferred = False

    # ---------------------------------------------------- host-side reads
    def get(self, key: bytes) -> bytes | None:
        return self.tree.get(key)

    def scan(self, lo: bytes, hi: bytes, max_items: int | None = None):
        return self.tree.scan(lo, hi, max_items)

    @property
    def serving_version(self) -> int:
        """Read version of the active snapshot — what a device batch that
        just dispatched here answered at (0 before the first publish)."""
        return self._snapshot_rv if self._snapshot_rv is not None else 0

    def routing(self) -> Routing:
        """The single-shard wiring for the service/scheduler (core/api.py):
        everything routes to shard 0, no replica spreading, reads stamped
        with the active snapshot's read version."""
        return Routing(
            shard_of=lambda key: 0,
            replica_of=None,
            report=lambda shard: (0, self.serving_version),
            live_version=lambda shard: int(self.tree.versions.read_version()))

    # ------------------------------------------------- snapshot mechanics
    def begin_export(self, force: bool = False, full: bool = False) -> bool:
        """Stage the host->device sync into the STANDBY snapshot.

        After the first wholesale publish, only dirty node rows + batched
        page-table commands + the read version cross the bus; ``full=True``
        forces a wholesale republish, ``force=True`` re-stages even when
        clean.  The ACTIVE snapshot keeps answering until ``flip()``.
        Returns True when a standby was (re)staged."""
        if ((self._snapshot is not None or self._standby is not None)
                and not self._snapshot_dirty and not force and not full):
            return False   # clean, and some epoch (staged or active) exists
        t0 = _now()
        t = self.tree
        h = t.heap
        stats = self.sync_stats
        stats.pagetable_commands += t.pt.sync_commands - self._pt_commands_seen
        self._pt_commands_seen = t.pt.sync_commands
        stats.read_version_updates += (t.versions.device_updates
                                       - self._rv_updates_seen)
        self._rv_updates_seen = t.versions.device_updates
        stats.snapshots += 1

        # an unflipped standby accumulates further deltas; otherwise the
        # active snapshot is the scatter base
        base = self._standby if self._standby is not None else self._snapshot
        dirty = h.dirty
        frac = len(dirty) / h.capacity
        can_delta = (base is not None and not full
                     and self._heap_gen == h.generation
                     and self._pt_gen == t.pt.generation
                     and frac <= self.cfg.delta_full_threshold)
        # refresh the interior cache BEFORE publishing so the staged
        # snapshot carries this epoch's cache frontier
        self.cache.refresh(t)
        bytes0 = stats.bytes_synced
        dmas0, ibytes0 = stats.image_dma_count, stats.image_bytes
        if can_delta:
            snap = self._publish_delta(base,
                                       np.fromiter(sorted(dirty), np.int32,
                                                   len(dirty)))
            stats.delta_syncs += 1
            stats.delta_rows += len(dirty)
            stats.delta_fraction = frac
            staged_kind, staged_rows = "delta", len(dirty)
        else:
            snap = self._publish_full()
            stats.full_syncs += 1
            stats.delta_fraction = 1.0
            staged_kind, staged_rows = "full", 0
        dirty.clear()
        self._heap_gen = h.generation
        self._pt_gen = t.pt.generation
        self._snapshot_dirty = False
        self._writes_since_sync = 0
        self._standby = snap
        self._standby_rv = int(t.versions.read_version())
        if self.cfg.sync_policy == "explicit" and self._standby_pin is None:
            # pin an accelerator epoch NOW, while the staged read version is
            # current, so host fallbacks can still walk version chains back
            # to it after the flip; the pin rolls forward at the next flip
            self._standby_pin = t.epochs.accel_begin_batch(1)
        self.pipeline_stats.staged_exports += 1
        self.pipeline_stats.export_s += _now() - t0
        # replication feed: record what crossed the bus and let the replica
        # group replay it into every follower's standby (after the export
        # meters close, so follower staging never pollutes primary timings)
        self.last_staged = StagedSync(
            kind=staged_kind, snapshot=snap,
            delta=self._staged_delta if staged_kind == "delta" else None,
            nbytes=stats.bytes_synced - bytes0, delta_rows=staged_rows,
            read_version=self._standby_rv,
            image_dmas=stats.image_dma_count - dmas0,
            image_bytes=stats.image_bytes - ibytes0,
            log_payload=self._build_log_payload(staged_kind))
        self._staged_delta = None
        # epoch boundary for the log-shipped feed: whatever happens next
        # belongs to the next staging
        self._epoch_log = []
        self._epoch_replayable = True
        san = _epochsan.get()
        if san is not None:   # tag the standby; audit the cache frontier
            san.note_staged(self, snap)
        if self.on_staged is not None:
            self.on_staged(self.last_staged)
        return True

    def _build_log_payload(self, staged_kind: str) -> LogPayload | None:
        """Encode the epoch's writes ONCE as the wire stream + placement
        sidecar every follower edge ships.  None — the per-epoch fallback —
        when capture is off, the staging was a full publish, the epoch saw
        a non-fast-path write or GC, or page-table commands rode the delta
        (the tree shape changed: a log replay could not reproduce them)."""
        if (not self.log_capture or staged_kind != "delta"
                or not self._epoch_replayable or self._staged_pt_cmds):
            return None
        log = self._epoch_log
        E = len(log)
        wire = b"".join(op.encode_wire() for op, _ in log)
        rows = np.fromiter((p[0] for _, p in log), np.int32, E)
        slots = np.fromiter((p[1] for _, p in log), np.int32, E)
        backptrs = np.fromiter((p[2] for _, p in log), np.int32, E)
        hints = np.fromiter((p[3] for _, p in log), np.int32, E)
        vdeltas = np.fromiter((p[4] for _, p in log), np.int64, E)
        sidecar = (rows.nbytes + slots.nbytes + backptrs.nbytes
                   + hints.nbytes + vdeltas.nbytes)
        return LogPayload(
            wire=wire, rows=rows, slots=slots, backptrs=backptrs,
            hints=hints, vdeltas=vdeltas, entries=E,
            read_version=self._standby_rv, wire_nbytes=len(wire),
            nbytes=len(wire) + sidecar)

    def flip(self) -> TreeSnapshot | None:
        """Publish the staged standby as the active snapshot — the atomic
        epoch advance of the double buffer.  No-op when nothing is
        staged."""
        if self._standby is None:
            return self._snapshot
        self._snapshot = self._standby
        self._snapshot_rv = self._standby_rv
        self._standby = None
        self._standby_rv = None
        self.epoch += 1
        self.pipeline_stats.flips += 1
        old_pin = self._snapshot_pin
        self._snapshot_pin = self._standby_pin
        self._standby_pin = None
        if old_pin is not None:
            self.tree.epochs.accel_complete_batch(*old_pin)
        san = _epochsan.get()
        if san is not None:               # retag the published snapshot
            san.note_flip(self, self._snapshot)
        if self.on_flip is not None:      # replica group: flip the followers
            self.on_flip()
        self.last_staged = None
        return self._snapshot

    def export_snapshot(self, force: bool = False,
                        full: bool = False) -> TreeSnapshot:
        """Host -> device sync: ``begin_export()`` then ``flip()``."""
        self.begin_export(force=force, full=full)
        return self.flip()   # no-op returning the active snapshot if clean

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A COPY of a 32-bit host array on the shard's device, as int32
        (u32 words keep their bit pattern)."""
        a = np.ascontiguousarray(arr)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert a.dtype == np.int32, a.dtype
        return torch.from_numpy(a).to(self.device, copy=True)

    def _publish_full(self):
        """Wholesale republish: the whole store crosses the bus — ONE
        contiguous [S, image_words] image copy on the packed layout, one
        tensor per field on legacy (same bytes, 24x the copies) — plus the
        page table."""
        t = self.tree
        h = t.heap
        pt_image = t.pt.flush_to_device()
        stats = self.sync_stats
        layout = NodeImageLayout.for_config(self.cfg)
        stats.image_bytes += h.capacity * layout.node_image_bytes
        if self.cfg.layout == "legacy":
            stats.image_dma_count += len(NODE_FIELDS)
            fields = {f: self._dev(self._field_rows(f)) for f in NODE_FIELDS}
            stats.bytes_synced += pt_image.nbytes + sum(
                x.nbytes for x in fields.values())
            return LegacyTreeSnapshot(
                pagetable=self._dev(pt_image), root_lid=int(t.root_lid),
                read_version=int(t.versions.read_version()), **fields)
        img = layout.pack(h)
        stats.bytes_synced += img.nbytes + pt_image.nbytes
        stats.image_dma_count += 1
        snap = TreeSnapshot(
            image=self._dev(img), pagetable=self._dev(pt_image),
            root_lid=int(t.root_lid),
            read_version=int(t.versions.read_version()),
            cache_lids=self._dev(self.cache.device_lids()))
        # materialize the cache tier on the device from the image just
        # shipped — only the ~KB LID vector crossed the bus
        return attach_cache_image(snap, self.cfg)

    def _field_rows(self, f: str, rows: np.ndarray | None = None):
        """Field ``f`` of the heap (of ``rows`` only, when given) as it
        crosses the bus on the legacy layout: 64-bit and byte-wide host
        fields narrowed to int32 (``_dev`` makes the device copy)."""
        arr = getattr(self.tree.heap, f)
        arr = arr[rows] if rows is not None else arr
        return arr.astype(np.int32) if f in NARROWED_FIELDS else arr

    def _publish_delta(self, base, rows: np.ndarray):
        """Incremental sync: scatter dirty node rows and pending page-table
        commands over ``base`` (the standby-in-progress, or the active
        snapshot when none is staged).  Moves (and meters) O(dirty) bytes.
        Packed: each dirty node is ONE contiguous image row
        (``image_dma_count`` grows by exactly len(rows)); legacy ships the
        same bytes as one row block per field (24 copies per node)."""
        t = self.tree
        h = t.heap
        stats = self.sync_stats
        layout = NodeImageLayout.for_config(self.cfg)
        pt_lids, pt_phys = t.pt.take_pending()
        # pending LID moves mean the tree shape changed under this epoch —
        # a log replay cannot reproduce them, so the feed must fall back
        self._staged_pt_cmds = len(pt_lids)
        # pad to bucketed sizes with repeats (duplicate indices carry
        # identical data); when empty, row/lid 0 rewrites itself with its
        # current contents (clean rows match the device image)
        rows_p = self._pad_index(rows, bucket_pow2(len(rows)))
        lids_p = self._pad_index(pt_lids, bucket_pow2(len(pt_lids)))
        phys_p = t.pt.device_image[lids_p]
        # both layouts move image_words * 4 bytes per UNPADDED dirty node;
        # only the copy count differs
        node_bytes = len(rows) * layout.node_image_bytes
        stats.image_bytes += node_bytes
        if self.cfg.layout == "legacy":
            stats.image_dma_count += len(rows) * len(NODE_FIELDS)
            delta = LegacySnapshotDelta(
                rows=self._dev(rows_p),
                pt_lids=self._dev(lids_p), pt_phys=self._dev(phys_p),
                root_lid=int(t.root_lid),
                read_version=int(t.versions.read_version()),
                **{f: self._dev(self._field_rows(f, rows_p))
                   for f in NODE_FIELDS})
        else:
            stats.image_dma_count += len(rows)
            delta = SnapshotDelta(
                rows=self._dev(rows_p),
                image=self._dev(layout.pack(h, rows_p)),
                pt_lids=self._dev(lids_p), pt_phys=self._dev(phys_p),
                root_lid=int(t.root_lid),
                read_version=int(t.versions.read_version()),
                cache_lids=self._dev(self.cache.device_lids()))
        stats.bytes_synced += pt_lids.nbytes + pt_phys.nbytes + node_bytes
        self._staged_delta = delta
        return apply_snapshot_delta(base, delta, cfg=self.cfg)

    @staticmethod
    def _pad_index(idx: np.ndarray, size: int) -> np.ndarray:
        idx = np.asarray(idx, np.int32)
        if len(idx) == 0:
            return np.zeros(size, np.int32)
        return np.concatenate(
            [idx, np.full(size - len(idx), idx[-1], np.int32)])

    # ------------------------------------------------- accelerated reads
    def _read_backend(self) -> str:
        """The read path of this shard's snapshots, a rule of the
        configuration: a legacy snapshot has no packed image for the fused
        kernel, so it is read through the per-level ``"reference"`` path;
        a packed one through ``cfg.read_backend``.  (A packed snapshot
        without its cache tier is never quietly read another way: the
        fused read raises on it.)"""
        if self.cfg.layout == "legacy":
            return "reference"
        return self.cfg.read_backend

    def _note_read_meters(self, meters: torch.Tensor):
        """Fold one fused dispatch's device meters into CacheStats."""
        vh, hg, lr = meters.tolist()
        s = self.cache.stats
        s.vmem_hits += vh
        s.heap_gathers += hg
        s.lb_routed += lr

    def snapshot_for_read(self) -> TreeSnapshot:
        """The snapshot device batches execute against.  "explicit" policy
        reads the resident (possibly stale, always consistent) snapshot;
        the other policies sync lazily here.  The first half of a batched
        read: ``get_batch(keys, snap)`` is the second."""
        if self.cfg.sync_policy == "explicit" and self._snapshot is not None:
            return self._snapshot
        return self.export_snapshot()

    def _fallback_read_version(self) -> int | None:
        """Read version for host fallbacks of device requests: the
        SNAPSHOT's under "explicit" (the epoch pin keeps those buffers
        alive), else the live tree's, which equals the snapshot's."""
        if self.cfg.sync_policy == "explicit" and self._snapshot_rv is not None:
            return self._snapshot_rv
        return None

    def get_batch(self, keys: Sequence[bytes],
                  snap: TreeSnapshot | None = None) -> list[bytes | None]:
        """Batched GET on the device path, epoch-stamped, against ``snap``
        (from ``snapshot_for_read``), by default the one it gives now."""
        keys = list(keys)
        if not keys:
            return []
        if snap is None:
            snap = self.snapshot_for_read()
        return self._device_get(snap, keys)

    def _device_get(self, snap: TreeSnapshot, keys: list[bytes],
                    read_backend: str | None = None) -> list[bytes | None]:
        """Execute one dense GET batch against ``snap`` — the active
        snapshot, or a follower replica's image (core/replica.py serves
        followers through the primary's dispatch).  ``read_backend=
        "reference"`` reads through the per-level path whatever the
        configuration says (the fused path's check)."""
        san = _epochsan.get()
        if san is not None:   # reads may never see an unflipped standby
            san.check_read(self, snap)
        padded = keys + [keys[0]] * (bucket_pow2(len(keys)) - len(keys))
        self.pipeline_stats.dispatched_lanes += len(keys)
        self.pipeline_stats.padded_lanes += len(padded)
        lanes, lens = pack_keys(padded, self.cfg.key_words)
        rb = read_backend or self._read_backend()
        kernel_ops.record_read_dispatch("get", rb, self.cfg)
        lo, hi = self.tree.epochs.accel_begin_batch(len(keys))
        try:
            key_t, len_t = self._dev(lanes), self._dev(lens)
            if rb == "fused":
                res, meters = kernel_ops.batched_get_fused(
                    snap, key_t, len_t, cfg=self.cfg,
                    lb_fraction=self.cfg.lb_fraction)
                self._note_read_meters(meters)
            else:
                res = batched_get(snap, key_t, len_t, self.cfg)
            found = res.found.cpu().numpy()
            vals = res.vals.cpu().numpy().view(np.uint32)
            vlens = res.vallens.cpu().numpy()
        finally:
            self.tree.epochs.accel_complete_batch(lo, hi)
        return [self._decode_value(vals[i], int(vlens[i])) if found[i]
                else None for i in range(len(keys))]

    def scan_batch(self, ranges: Sequence[tuple[bytes, bytes]]
                   ) -> list[list[tuple[bytes, bytes]]]:
        """Batched SCAN on the device path.  Requests the device could not
        complete (leaf budget/slots) fall back to the host tree — the paper
        likewise runs some SCANs on CPU cores (Section 6.3)."""
        ranges = list(ranges)
        if not ranges:
            return []
        snap = self.snapshot_for_read()
        return self._device_scan(snap, ranges, self._fallback_read_version())

    def _device_scan(self, snap: TreeSnapshot,
                     ranges: list[tuple[bytes, bytes]],
                     fallback_rv: int | None,
                     read_backend: str | None = None
                     ) -> list[list[tuple[bytes, bytes]]]:
        """Execute one dense SCAN batch against ``snap``; truncated
        requests fall back to the host tree at ``fallback_rv``.
        ``read_backend`` as for ``_device_get``."""
        san = _epochsan.get()
        if san is not None:   # reads may never see an unflipped standby
            san.check_read(self, snap)
        padded = ranges + [ranges[0]] * (bucket_pow2(len(ranges))
                                         - len(ranges))
        self.pipeline_stats.dispatched_lanes += len(ranges)
        self.pipeline_stats.padded_lanes += len(padded)
        lo_l, lo_n = pack_keys([r[0] for r in padded], self.cfg.key_words)
        hi_l, hi_n = pack_keys([r[1] for r in padded], self.cfg.key_words)
        rb = read_backend or self._read_backend()
        kernel_ops.record_read_dispatch("scan", rb, self.cfg)
        slo, shi = self.tree.epochs.accel_begin_batch(len(ranges))
        try:
            args = (self._dev(lo_l), self._dev(lo_n), self._dev(hi_l),
                    self._dev(hi_n))
            if rb == "fused":
                res, meters = kernel_ops.batched_scan_fused(
                    snap, *args, cfg=self.cfg,
                    lb_fraction=self.cfg.lb_fraction)
                self._note_read_meters(meters)
            else:
                res = batched_scan(snap, *args, self.cfg)
            count = res.count.cpu().numpy()
            keys = res.keys.cpu().numpy().view(np.uint32)
            klens = res.keylens.cpu().numpy()
            vals = res.vals.cpu().numpy().view(np.uint32)
            vlens = res.vallens.cpu().numpy()
            trunc = res.truncated.cpu().numpy()
        finally:
            self.tree.epochs.accel_complete_batch(slo, shi)
        self.scan_fallbacks += int(trunc[:len(ranges)].sum())
        out = []
        for b, (lo, hi) in enumerate(ranges):
            if trunc[b]:
                out.append(self.tree.scan(lo, hi, read_version=fallback_rv))
                continue
            items = []
            for j in range(int(count[b])):
                k = keys[b, j].astype(">u4").tobytes()[: int(klens[b, j])]
                items.append((k, self._decode_value(vals[b, j],
                                                    int(vlens[b, j]))))
            out.append(items)
        return out

    def _decode_value(self, lanes: np.ndarray, length: int) -> bytes:
        if length <= self.cfg.max_inline_val_bytes:
            return lanes.astype(">u4").tobytes()[:length]
        return self.tree.overflow.read(int(lanes[0]))

    # ------------------------------------------------------------- misc
    def collect_garbage(self) -> int:
        san = _epochsan.get()
        # audit the collect against the PRE-collect epoch window: nothing
        # a pinned accelerator/CPU epoch still covers may be reclaimed
        guard = san.gc_begin(self) if san is not None else None
        n = self.tree.gc.collect()
        if guard is not None:
            san.gc_end(self, guard)
        if n:
            # GC wipes freed slots (marking them dirty) and queues LID
            # frees — row mutations no wire entry describes, so the
            # epoch's staging must ship the image delta
            self._epoch_replayable = False
            self._epoch_log.clear()
        return n

    @property
    def stats(self):
        return self.tree.stats

    @property
    def cache_stats(self):
        """The interior cache's meters (metadata-table probes plus the
        fused read path's cache/heap split)."""
        return self.cache.stats
