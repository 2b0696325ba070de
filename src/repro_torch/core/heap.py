"""Node heap: structure-of-arrays storage for B+Tree node buffers.

The paper allocates fixed 8 KB node buffers in pinned host memory and
addresses them physically (Section 3.1).  Here a *physical slot* is a row
across a set of packed numpy arrays, marshalled into the packed node image
(core/schema.py) that the device read path and its kernels consume.  Buffers are never mutated after they are
published to readers except for the leaf fast path (log append), exactly
mirroring the paper: structural changes allocate fresh slots and swap a LID
mapping (Section 3.4); the in-place log append is made safe by MVCC version
filtering (Section 3.2).

The 64-bit packed (size, lock, seqno) word of the paper's header is kept as
``lockword``: bit 63 = lock bit, bits 32..62 = sequence number, low 32 bits =
bytes-used stand-in (item count).  ``try_lock`` implements the
compare-and-swap-with-expected-seqno protocol of Section 3.4.
"""
from __future__ import annotations

import numpy as np

from .config import HoneycombConfig
from .schema import FIELD_NAMES, NODE_SCHEMA

INTERIOR, LEAF = 0, 1
NULL = -1

# log entry op codes (paper Section 3.1: inserted/updated items or delete
# markers)
LOG_INSERT, LOG_UPDATE, LOG_DELETE = 0, 1, 2

_LOCK_BIT = np.int64(1) << np.int64(63)
_SEQ_SHIFT = np.int64(32)
_SEQ_MASK = (np.int64(1) << np.int64(31)) - np.int64(1)


class NodeHeap:
    """Slab of node buffers with a free list."""

    def __init__(self, cfg: HoneycombConfig, capacity: int = 1024):
        self.cfg = cfg
        self.capacity = 0
        self._free: list[int] = []
        # rows whose packed arrays changed since the last device sync — the
        # unit of host->accelerator delta transfer (paper: one node buffer)
        self.dirty: set[int] = set()
        # bumped when the arrays are reallocated (growth): resident device
        # snapshots have the old shapes and need a full republish
        self.generation = 0
        self._alloc_arrays(capacity)

    # -- storage -------------------------------------------------------------
    def _alloc_arrays(self, capacity: int):
        c = self.cfg
        old = self.capacity

        def grow(name, shape, dtype, fill=0):
            new = np.full((capacity, *shape), fill, dtype=dtype)
            if old:
                new[:old] = getattr(self, name)
            setattr(self, name, new)

        # every device-visible per-node field comes from the one layout
        # schema (core/schema.py) — same names, order, host dtypes and NULL
        # fills the packed node image is defined over.  svals lane 0 holds
        # the child LID on interior nodes; svallen doubles as overflow tag.
        for spec in NODE_SCHEMA:
            grow(spec.name, spec.shape(c), np.dtype(spec.host), spec.fill)
        # host-only lock/seqno word (Section 3.4): never crosses the bus,
        # so it lives outside the schema
        grow("lockword", (), np.int64)

        self._free.extend(range(capacity - 1, old - 1, -1))
        self.capacity = capacity
        self.generation += 1

    # device-visible per-node fields, in schema/layout order
    ARRAY_FIELDS = FIELD_NAMES

    # -- alloc / free ----------------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            self._alloc_arrays(self.capacity * 2)
        slot = self._free.pop()
        self.dirty.add(slot)       # caller fills the buffer next
        return slot

    def free(self, slot: int):
        self._wipe(slot)
        self.dirty.add(slot)
        self._free.append(slot)

    def mark_dirty(self, slot: int):
        """Record an in-place mutation of a published buffer (log append,
        sibling relink) for the next delta sync."""
        self.dirty.add(slot)

    def _wipe(self, s: int):
        self.ntype[s] = 0
        self.nitems[s] = 0
        self.version[s] = 0
        self.oldptr[s] = NULL
        self.left_child[s] = NULL
        self.lsib[s] = NULL
        self.rsib[s] = NULL
        self.lockword[s] = 0
        self.n_shortcuts[s] = 0
        self.nlog[s] = 0
        self.skeylen[s] = 0
        self.svallen[s] = 0

    @property
    def live_slots(self) -> int:
        return self.capacity - len(self._free)

    # -- lock word (Section 3.4) ----------------------------------------------
    def seqno(self, s: int) -> int:
        return int((self.lockword[s] >> _SEQ_SHIFT) & _SEQ_MASK)

    def is_locked(self, s: int) -> bool:
        return bool(self.lockword[s] & _LOCK_BIT)

    def try_lock(self, s: int, expected_seqno: int) -> bool:
        """CAS(lock=0, seqno=expected) -> lock=1.  Single host process, so a
        plain check-and-set is an atomic CAS; the protocol (restart on seqno
        mismatch) is what the tests exercise."""
        if self.is_locked(s) or self.seqno(s) != expected_seqno:
            return False
        self.lockword[s] |= _LOCK_BIT
        return True

    def unlock_bump(self, s: int):
        """Paper: size/seqno/lock packed in one word so the update is a single
        store — here: clear lock, increment seqno."""
        seq = (self.seqno(s) + 1) & int(_SEQ_MASK)
        self.lockword[s] = (np.int64(seq) << _SEQ_SHIFT)

    def unlock(self, s: int):
        self.lockword[s] &= ~_LOCK_BIT


class OverflowHeap:
    """Out-of-node value storage (paper: values > 469 B live outside the
    node).  Values are immutable once written; slots are recycled via GC."""

    def __init__(self, cfg: HoneycombConfig, capacity: int = 256):
        self.cfg = cfg
        self.vals = np.zeros((capacity, cfg.overflow_words), np.uint32)
        self.lens = np.zeros((capacity,), np.int32)
        self._free = list(range(capacity - 1, -1, -1))

    def alloc(self, data: bytes) -> int:
        if not self._free:
            cap = len(self.lens)
            self.vals = np.concatenate([self.vals, np.zeros_like(self.vals)])
            self.lens = np.concatenate([self.lens, np.zeros_like(self.lens)])
            self._free.extend(range(2 * cap - 1, cap - 1, -1))
        slot = self._free.pop()
        buf = data + b"\x00" * (-len(data) % 4)
        lanes = np.frombuffer(buf, dtype=">u4").astype(np.uint32)
        self.vals[slot, :] = 0
        self.vals[slot, : len(lanes)] = lanes
        self.lens[slot] = len(data)
        return slot

    def read(self, slot: int) -> bytes:
        n = int(self.lens[slot])
        return self.vals[slot].astype(">u4").tobytes()[:n]

    def free(self, slot: int):
        self.lens[slot] = 0
        self._free.append(slot)
