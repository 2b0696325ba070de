"""Epoch-based memory reclamation (paper Section 3.2).

Writers that replace node buffers push the old physical slots onto a garbage
list tagged with a *vector timestamp*: the current operation sequence number
of every CPU thread plus the newest inflight sequence number on the
accelerator (S_new).  A slot is reclaimable once every CPU thread has moved
past its entry and the accelerator's *oldest* inflight operation (S_old) is
newer than the accelerator entry.

The accelerator epoch window [S_old, S_new] maps to batched execution: a
batch of reads stamped with sequence numbers [s, s+B) holds the epoch open
until the batch completes (the snapshot it executed against may reference the
old slots).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable


@dataclasses.dataclass
class GarbageEntry:
    slots: tuple[int, ...]          # physical node slots to reclaim
    lids: tuple[int, ...]           # LIDs to recycle (split/merge leftovers)
    overflow: tuple[int, ...]       # overflow-heap slots
    cpu_stamp: dict[int, int]       # thread id -> op seqno at enqueue
    accel_stamp: int                # accelerator S_new at enqueue


class EpochManager:
    """Tracks per-thread CPU op sequence numbers and the accelerator's
    [S_old, S_new] inflight window (paper Section 4.1)."""

    def __init__(self):
        self.cpu_seq: dict[int, int] = {}
        self.accel_s_new = 0
        self._accel_inflight: dict[int, bool] = {}  # seqno -> done?

    def cpu_begin(self, thread: int) -> int:
        self.cpu_seq[thread] = self.cpu_seq.get(thread, 0) + 1
        return self.cpu_seq[thread]

    def accel_begin_batch(self, n: int) -> tuple[int, int]:
        """Assign sequence numbers to a batch of accelerator requests."""
        lo = self.accel_s_new + 1
        self.accel_s_new += n
        for s in range(lo, self.accel_s_new + 1):
            self._accel_inflight[s] = False
        return lo, self.accel_s_new

    def accel_complete_batch(self, lo: int, hi: int):
        for s in range(lo, hi + 1):
            self._accel_inflight[s] = True
        # retire the completed prefix
        for s in sorted(self._accel_inflight):
            if self._accel_inflight[s]:
                del self._accel_inflight[s]
            else:
                break

    @property
    def accel_s_old(self) -> int:
        """Oldest inflight accelerator op (== S_new + 1 when idle)."""
        if self._accel_inflight:
            return min(self._accel_inflight)
        return self.accel_s_new + 1


class GarbageCollector:
    def __init__(self, epochs: EpochManager,
                 free_slot: Callable[[int], None],
                 free_lid: Callable[[int], None],
                 free_overflow: Callable[[int], None]):
        self.epochs = epochs
        self.list: deque[GarbageEntry] = deque()
        self._free_slot = free_slot
        self._free_lid = free_lid
        self._free_overflow = free_overflow
        self.reclaimed = 0

    def defer(self, slots=(), lids=(), overflow=()):
        self.list.append(GarbageEntry(
            slots=tuple(slots), lids=tuple(lids), overflow=tuple(overflow),
            cpu_stamp=dict(self.epochs.cpu_seq),
            accel_stamp=self.epochs.accel_s_new))

    def _reclaimable(self, e: GarbageEntry) -> bool:
        for t, s in e.cpu_stamp.items():
            if self.epochs.cpu_seq.get(t, 0) <= s:
                return False
        return self.epochs.accel_s_old > e.accel_stamp

    def collect(self) -> int:
        """Scan the garbage list and reclaim everything unreachable."""
        kept: deque[GarbageEntry] = deque()
        n = 0
        while self.list:
            e = self.list.popleft()
            if self._reclaimable(e):
                for s in e.slots:
                    self._free_slot(s)
                for lid in e.lids:
                    self._free_lid(lid)
                for o in e.overflow:
                    self._free_overflow(o)
                n += 1
            else:
                kept.append(e)
        self.list = kept
        self.reclaimed += n
        return n

    def __len__(self):
        return len(self.list)
