"""Host-side B+Tree writer (paper Sections 3.1, 3.4, 3.5).

All mutations run here, on the CPU, in numpy — PUT/UPDATE/DELETE fast paths
(log append), sorted+log merges, node splits/merges, and tree growth.  The
accelerator (the batched PyTorch/CUDA read path) only ever *reads* the arrays
this module maintains.

Protocol fidelity notes:
  * fast path:   lock leaf via CAS on (lock|seqno), append to the log block
                 with back pointer + order hint + version delta, publish via
                 a single packed (size|seqno|lock) store.
  * merge:       new buffer, same LID; version = wv; oldptr -> old buffer;
                 one page-table remap (the per-merge "PCIe command").
  * split:       new LIDs + buffers for both halves of every split node; new
                 buffer, same LID, for the root of the split; in-place sibling
                 pointer updates on the (locked) adjacent leaves; old-version
                 pointers stamped so old-read-version scans traverse the old
                 subtree (linearizable scans, Section 3.4).
  * delete:      delete markers in the log; space reclaimed at merge; leaf
                 underflow merges with its right sibling under the same
                 parent (Section 3.5: "similar techniques ... omit details").

Back-pointer convention (Section 3.1): a log entry points at the sorted-block
item with an equal key if one exists, else at the first sorted item with a
greater key.  The merged enumeration therefore emits log entries immediately
before the sorted item their back pointer names, which keeps the emission
key-ordered; equal keys come out adjacent, newest version first (the order
hints place later equal inserts earlier), so readers resolve duplicates by
taking the maximum visible version (Section 3.3).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .config import HoneycombConfig
from .gc import EpochManager, GarbageCollector
from .heap import (INTERIOR, LEAF, LOG_DELETE, LOG_INSERT, LOG_UPDATE, NULL,
                   NodeHeap, OverflowHeap)
from .keys import key_cmp, pack_key
from .mvcc import VersionManager
from .pagetable import PageTable
from .telemetry import samples_from

MAX_RESTARTS = 64


class _Restart(Exception):
    """Lock acquisition failed against a changed seqno — retry the op."""


@dataclasses.dataclass
class TreeStats:
    puts: int = 0
    updates: int = 0
    deletes: int = 0
    fast_path: int = 0
    merges: int = 0
    splits: int = 0
    node_merges: int = 0
    restarts: int = 0
    grows: int = 0

    def collect(self):
        """Registry samples (core/telemetry.py collect protocol):
        ``tree_*`` counters for the host writer's op/maintenance mix."""
        return samples_from(self, "tree", "btree")


@dataclasses.dataclass
class _PathEntry:
    lid: int
    phys: int
    seqno: int
    slot_in_parent: int  # -1 => reached via parent's left_child


class HoneycombTree:
    def __init__(self, cfg: HoneycombConfig | None = None,
                 heap_capacity: int = 1024):
        self.cfg = cfg or HoneycombConfig()
        self.heap = NodeHeap(self.cfg, heap_capacity)
        self.overflow = OverflowHeap(self.cfg)
        self.pt = PageTable(heap_capacity)
        self.versions = VersionManager(self.cfg.mvcc)
        self.epochs = EpochManager()
        self.gc = GarbageCollector(
            self.epochs, self.heap.free, self.pt.free_lid, self.overflow.free)
        self.stats = TreeStats()
        self.last_placement = None   # set per write; see _write

        # bootstrap: the tree is a single empty leaf
        root_phys = self.heap.alloc()
        self.heap.ntype[root_phys] = LEAF
        self.root_lid = self.pt.alloc_lid(root_phys)
        self.height = 1  # levels; a leaf-only tree has height 1

    # ------------------------------------------------------------------ util
    def _pack(self, key: bytes) -> tuple[np.ndarray, int]:
        return pack_key(key, self.cfg.key_words), len(key)

    @staticmethod
    def _key_bytes(lanes: np.ndarray, length: int) -> bytes:
        return lanes.astype(">u4").tobytes()[:length]

    def _store_value(self, val: bytes, out_lanes: np.ndarray) -> int:
        """Inline a value or place it in the overflow heap (paper: values
        above the inline limit live out of node).  Returns byte length."""
        out_lanes[:] = 0
        if len(val) <= self.cfg.max_inline_val_bytes:
            buf = val + b"\x00" * (-len(val) % 4)
            lanes = np.frombuffer(buf, dtype=">u4").astype(np.uint32)
            out_lanes[: len(lanes)] = lanes
        else:
            out_lanes[0] = self.overflow.alloc(val)
        return len(val)

    def _load_value(self, lanes: np.ndarray, length: int) -> bytes:
        if length <= self.cfg.max_inline_val_bytes:
            return lanes.astype(">u4").tobytes()[:length]
        return self.overflow.read(int(lanes[0]))

    def _defer_value(self, lanes, length):
        """GC the overflow slot behind a value that left the live tree."""
        if length > self.cfg.max_inline_val_bytes:
            self.gc.defer(overflow=(int(lanes[0]),))

    # ------------------------------------------------------- node inspection
    def _floor_in_sorted(self, phys: int, klanes, klen) -> int:
        """Largest sorted-block index with key <= query, or -1."""
        h = self.heap
        lo, hi, ans = 0, int(h.nitems[phys]) - 1, -1
        while lo <= hi:
            mid = (lo + hi) // 2
            if key_cmp(h.skeys[phys, mid], int(h.skeylen[phys, mid]),
                       klanes, klen) <= 0:
                ans, lo = mid, mid + 1
            else:
                hi = mid - 1
        return ans

    def _log_backptr(self, phys: int, klanes, klen) -> int:
        """Exact-match index if present, else the upper bound."""
        i = self._floor_in_sorted(phys, klanes, klen)
        h = self.heap
        if i >= 0 and key_cmp(h.skeys[phys, i], int(h.skeylen[phys, i]),
                              klanes, klen) == 0:
            return i
        return i + 1

    def _interior_child(self, phys: int, klanes, klen) -> tuple[int, int]:
        """(child LID, slot index or -1 for left_child)."""
        i = self._floor_in_sorted(phys, klanes, klen)
        if i < 0:
            return int(self.heap.left_child[phys]), -1
        return int(self.heap.svals[phys, i, 0]), i

    # ------------------------------------------------------------- traversal
    def _traverse(self, klanes, klen) -> list[_PathEntry]:
        """Root->leaf walk on the latest versions (writer semantics),
        recording (lid, phys, seqno) for later lock validation."""
        path: list[_PathEntry] = []
        lid, slot = self.root_lid, -1
        for _ in range(self.cfg.max_height + 1):
            phys = self.pt.lookup(lid)
            path.append(_PathEntry(lid=lid, phys=phys,
                                   seqno=self.heap.seqno(phys),
                                   slot_in_parent=slot))
            if int(self.heap.ntype[phys]) == LEAF:
                return path
            lid, slot = self._interior_child(phys, klanes, klen)
        raise RuntimeError("tree height exceeded max_height")

    # --------------------------------------------------------------- reading
    def _resolve_version(self, phys: int, rv: int | None) -> int:
        """Follow the old-version chain until version <= rv (Section 3.2)."""
        h = self.heap
        hops = 0
        while rv is not None and int(h.version[phys]) > rv:
            phys = int(h.oldptr[phys])
            hops += 1
            if phys == NULL or hops > self.cfg.max_version_chain:
                raise RuntimeError("version chain exhausted under reader")
        return phys

    def _resolved_leaf_items(self, phys: int, rv: int | None,
                             with_lanes: bool = False) -> list:
        """Live (key, value) pairs of one leaf at read version rv, sorted.
        This is the reference semantics of the sorted+log merge."""
        h = self.heap
        nv = int(h.version[phys])
        by_key: dict[bytes, tuple[int, int, object, int]] = {}
        for i in range(int(h.nitems[phys])):
            k = self._key_bytes(h.skeys[phys, i], int(h.skeylen[phys, i]))
            by_key[k] = (nv, 0, h.svals[phys, i], int(h.svallen[phys, i]))
        for j in range(int(h.nlog[phys])):
            ver = nv + int(h.log_vdelta[phys, j])
            if rv is not None and ver > rv:
                continue
            k = self._key_bytes(h.log_keys[phys, j],
                                int(h.log_keylen[phys, j]))
            prev = by_key.get(k)
            if prev is not None and (ver, j + 1) < (prev[0], prev[1]):
                continue
            if int(h.log_op[phys, j]) == LOG_DELETE:
                by_key[k] = (ver, j + 1, None, 0)
            else:
                by_key[k] = (ver, j + 1, h.log_vals[phys, j],
                             int(h.log_vallen[phys, j]))
        out = []
        for k in sorted(by_key):
            ver, _, lanes, ln = by_key[k]
            if lanes is None:
                continue
            if with_lanes:
                out.append((k, np.array(lanes, np.uint32), ln))
            else:
                out.append((k, self._load_value(np.asarray(lanes), ln)))
        return out

    def get(self, key: bytes, read_version: int | None = None,
            latest: bool = False) -> bytes | None:
        """Host-side GET.  Readers run at the released read version
        (linearizable); writers pass ``latest`` to see their own effects."""
        rv = None if latest else (
            self.versions.read_version() if read_version is None
            else read_version)
        klanes, klen = self._pack(key)
        h = self.heap
        lid = self.root_lid
        for _ in range(self.cfg.max_height + 1):
            phys = self._resolve_version(self.pt.lookup(lid), rv)
            if int(h.ntype[phys]) == LEAF:
                nv = int(h.version[phys])
                best: tuple[int, int] | None = None   # (version, tag)
                i = self._floor_in_sorted(phys, klanes, klen)
                if i >= 0 and key_cmp(h.skeys[phys, i],
                                      int(h.skeylen[phys, i]),
                                      klanes, klen) == 0:
                    best = (nv, -i - 1)
                for j in range(int(h.nlog[phys])):
                    ver = nv + int(h.log_vdelta[phys, j])
                    if rv is not None and ver > rv:
                        continue
                    if key_cmp(h.log_keys[phys, j],
                               int(h.log_keylen[phys, j]),
                               klanes, klen) != 0:
                        continue
                    if best is None or (ver, j + 1) >= best:
                        best = (ver, j + 1)
                if best is None:
                    return None
                _, tag = best
                if tag < 0:
                    si = -tag - 1
                    return self._load_value(h.svals[phys, si],
                                            int(h.svallen[phys, si]))
                j = tag - 1
                if int(h.log_op[phys, j]) == LOG_DELETE:
                    return None
                return self._load_value(h.log_vals[phys, j],
                                        int(h.log_vallen[phys, j]))
            lid, _ = self._interior_child(phys, klanes, klen)
        raise RuntimeError("tree height exceeded max_height")

    def scan(self, lo: bytes, hi: bytes, max_items: int | None = None,
             read_version: int | None = None) -> list[tuple[bytes, bytes]]:
        """SCAN(K_l, K_u) with the paper's floor-start semantics: begins at
        the largest key <= K_l if one exists (Section 3.3)."""
        rv = (self.versions.read_version() if read_version is None
              else read_version)
        if not self.cfg.mvcc:
            rv = None
        h = self.heap
        lolanes, lolen = self._pack(lo)
        lid = self.root_lid
        phys = self._resolve_version(self.pt.lookup(lid), rv)
        while int(h.ntype[phys]) == INTERIOR:
            lid, _ = self._interior_child(phys, lolanes, lolen)
            phys = self._resolve_version(self.pt.lookup(lid), rv)

        # locate the floor: walk left while this leaf holds nothing <= lo
        floor: tuple[bytes, bytes] | None = None
        start_phys = phys
        for _ in range(64):
            items = self._resolved_leaf_items(start_phys, rv)
            below = [kv for kv in items if kv[0] <= lo]
            if below:
                floor = below[-1]
                break
            nxt = int(h.lsib[start_phys])
            if nxt == NULL:
                break
            start_phys = self._resolve_version(self.pt.lookup(nxt), rv)

        out: list[tuple[bytes, bytes]] = []
        if floor is not None:
            out.append(floor)
            if floor[0] > hi or (max_items and len(out) >= max_items):
                return [kv for kv in out if kv[0] <= hi]
        # forward scan from the descent leaf
        hops = 0
        while phys != NULL and hops < 1024:
            hops += 1
            for k, v in self._resolved_leaf_items(phys, rv):
                if k > hi:
                    return out
                if k <= lo:
                    continue  # floor already emitted
                out.append((k, v))
                if max_items and len(out) >= max_items:
                    return out
            nxt = int(h.rsib[phys])
            phys = (self._resolve_version(self.pt.lookup(nxt), rv)
                    if nxt != NULL else NULL)
        return out

    # ------------------------------------------------------------ write ops
    def put(self, key: bytes, value: bytes, thread: int = 0):
        self.stats.puts += 1
        self._write(key, value, LOG_INSERT, thread)

    def update(self, key: bytes, value: bytes, thread: int = 0):
        self.stats.updates += 1
        self._write(key, value, LOG_UPDATE, thread)

    def delete(self, key: bytes, thread: int = 0):
        self.stats.deletes += 1
        self._write(key, b"", LOG_DELETE, thread)

    def _write(self, key: bytes, value: bytes, op: int, thread: int = 0):
        klanes, klen = self._pack(key)
        # placement record of THIS write if (and only if) it takes the log
        # fast path — (phys, slot, backptr, hint, vdelta), the sidecar the
        # log-shipped replication feed (core/replica.py) needs to replay
        # the wire entry on a follower image.  Merge/split/underflow paths
        # leave it None: those epochs are not replayable.
        self.last_placement = None
        self.epochs.cpu_begin(thread)
        for _ in range(MAX_RESTARTS):
            path = self._traverse(klanes, klen)
            leaf = path[-1]
            if not self.heap.try_lock(leaf.phys, leaf.seqno):
                self.stats.restarts += 1
                continue
            try:
                if int(self.heap.nlog[leaf.phys]) < self.cfg.log_cap:
                    self._fast_path(leaf.phys, klanes, klen, value, op)
                    self.stats.fast_path += 1
                else:
                    self._merge_path(path, klanes, klen, value, op)
                return
            except _Restart:
                continue
        raise RuntimeError("write restarted too many times")

    def _fast_path(self, phys: int, klanes, klen, value: bytes, op: int):
        """Append to the log block of a published leaf (Section 3.4).
        Readers ignore the entry until its version is released."""
        h = self.heap
        j = int(h.nlog[phys])
        nv = int(h.version[phys])
        wv = self.versions.acquire_write_version()
        hint = 0   # rank among current log entries (strictly smaller keys)
        for e in range(j):
            if key_cmp(h.log_keys[phys, e], int(h.log_keylen[phys, e]),
                       klanes, klen) < 0:
                hint += 1
        h.log_keys[phys, j] = klanes
        h.log_keylen[phys, j] = klen
        h.log_vallen[phys, j] = self._store_value(value, h.log_vals[phys, j])
        h.log_op[phys, j] = op
        h.log_backptr[phys, j] = self._log_backptr(phys, klanes, klen)
        h.log_hint[phys, j] = hint
        h.log_vdelta[phys, j] = wv - nv
        self.last_placement = (phys, j, int(h.log_backptr[phys, j]),
                               hint, wv - nv)
        # publish: the paper packs (size | seqno | lock) into one word so the
        # count bump, seqno bump and unlock are a single store
        h.nlog[phys] = j + 1
        h.mark_dirty(phys)         # in-place append -> delta sync this row
        h.unlock_bump(phys)
        self.versions.release(wv)

    # ------------------------------------------------------------ merge path
    def _merge_path(self, path: list[_PathEntry], klanes, klen,
                    value: bytes, op: int):
        """Log merge (Fig. 3), escalating to a split (Fig. 4) on overflow or
        to a sibling merge on underflow.  Leaf lock is held on entry; every
        exit path unlocks."""
        leaf = path[-1]
        # resolve current leaf contents (latest versions — writer view)
        resolved = self._resolved_leaf_items(leaf.phys, rv=None,
                                             with_lanes=True)
        ent = {k: (lanes, ln) for k, lanes, ln in resolved}
        key = self._key_bytes(klanes, klen)
        if key in ent:
            self._defer_value(*ent[key])
        if op == LOG_DELETE:
            ent.pop(key, None)
        else:
            vlanes = np.zeros(self.cfg.val_words, np.uint32)
            vlen = self._store_value(value, vlanes)
            ent[key] = (vlanes, vlen)
        items = [(k, *ent[k]) for k in sorted(ent)]

        if len(items) > self.cfg.node_cap:
            self._split(path, items)
        elif (len(items) < self.cfg.min_fill * self.cfg.node_cap
              and len(path) > 1):
            self._underflow(path, items)
        else:
            self._rebuild_leaf(path, items)

    # ------------------------------------------------------------ node fills
    def _fill_leaf(self, phys: int, items, wv: int):
        """Fresh leaf buffer: sorted block + shortcut selection (Fig. 3)."""
        c, h = self.cfg, self.heap
        h.ntype[phys] = LEAF
        n = len(items)
        h.nitems[phys] = n
        h.version[phys] = wv if c.mvcc else 0
        h.nlog[phys] = 0
        for i, (k, vlanes, vlen) in enumerate(items):
            h.skeys[phys, i] = pack_key(k, c.key_words)
            h.skeylen[phys, i] = len(k)
            h.svals[phys, i] = vlanes
            h.svallen[phys, i] = vlen
        self._fill_shortcuts(phys, [k for k, _, _ in items])

    def _fill_interior(self, phys: int, left_child: int, items, wv: int):
        """items: [(key_bytes, child_lid)]"""
        c, h = self.cfg, self.heap
        h.ntype[phys] = INTERIOR
        h.left_child[phys] = left_child
        n = len(items)
        h.nitems[phys] = n
        h.version[phys] = wv if c.mvcc else 0
        h.nlog[phys] = 0
        for i, (k, child) in enumerate(items):
            h.skeys[phys, i] = pack_key(k, c.key_words)
            h.skeylen[phys, i] = len(k)
            h.svals[phys, i] = 0
            h.svals[phys, i, 0] = child
            h.svallen[phys, i] = 4
        self._fill_shortcuts(phys, [k for k, _ in items])

    def _fill_shortcuts(self, phys: int, keys: list[bytes]):
        """Shortcut selection (Section 3.4): the paper balances segment
        bytes; with fixed-width slots the item count is the byte proxy."""
        c, h = self.cfg, self.heap
        n = len(keys)
        nsc = max(1, min(c.n_shortcuts, -(-n // c.segment_items)))
        h.n_shortcuts[phys] = nsc
        h.sc_keylen[phys, :] = 0
        for s in range(nsc):
            pos = s * c.segment_items
            h.sc_pos[phys, s] = pos
            if pos < n:
                h.sc_keys[phys, s] = pack_key(keys[pos], c.key_words)
                h.sc_keylen[phys, s] = len(keys[pos])

    def _interior_items(self, phys: int) -> list[tuple[bytes, int]]:
        h = self.heap
        return [(self._key_bytes(h.skeys[phys, i], int(h.skeylen[phys, i])),
                 int(h.svals[phys, i, 0]))
                for i in range(int(h.nitems[phys]))]

    # -------------------------------------------------------------- rebuild
    def _rebuild_leaf(self, path: list[_PathEntry], items):
        """Merge of sorted and log blocks (Fig. 3): new buffer, same LID."""
        leaf = path[-1]
        wv = self.versions.acquire_write_version()
        h = self.heap
        new_phys = h.alloc()
        self._fill_leaf(new_phys, items, wv)
        h.lsib[new_phys] = h.lsib[leaf.phys]
        h.rsib[new_phys] = h.rsib[leaf.phys]
        h.oldptr[new_phys] = leaf.phys if self.cfg.mvcc else NULL
        self.pt.remap(leaf.lid, new_phys)          # Fig. 3c
        h.unlock_bump(leaf.phys)                   # old buffer retires
        self.gc.defer(slots=(leaf.phys,))
        self.versions.release(wv)
        self.stats.merges += 1

    # ------------------------------------------------------------------ split
    def _split(self, path: list[_PathEntry], items):
        """Split the leaf (and full ancestors) — Fig. 4.  ``items`` is the
        merged item list that overflows the leaf; the leaf lock is held."""
        c, h = self.cfg, self.heap
        # the split cascades through every full ancestor
        split_levels = [path[-1]]
        k = len(path) - 2
        while k >= 0 and int(h.nitems[path[k].phys]) >= c.node_cap:
            split_levels.append(path[k])
            k -= 1
        root_of_split = path[k] if k >= 0 else None

        # paper: lock all interior nodes to split plus the root of the split
        to_lock = split_levels[1:] + ([root_of_split] if root_of_split else [])
        got = []
        for e in to_lock:
            if not self.heap.try_lock(e.phys, self.heap.seqno(e.phys)):
                for g in got:
                    h.unlock(g.phys)
                h.unlock(path[-1].phys)
                self.stats.restarts += 1
                raise _Restart()
            got.append(e)

        wv = self.versions.acquire_write_version()
        gc_slots: list[int] = []
        gc_lids: list[int] = []

        # --- leaf level -----------------------------------------------------
        leaf = path[-1]
        mid = len(items) // 2
        lphys, rphys = h.alloc(), h.alloc()
        self._fill_leaf(lphys, items[:mid], wv)
        self._fill_leaf(rphys, items[mid:], wv)
        llid, rlid = self.pt.alloc_lid(lphys), self.pt.alloc_lid(rphys)
        h.lsib[lphys] = h.lsib[leaf.phys]
        h.rsib[lphys] = rlid
        h.lsib[rphys] = llid
        h.rsib[rphys] = h.rsib[leaf.phys]
        if c.mvcc:   # old-read-version scans reach the old leaf (Section 3.4)
            h.oldptr[lphys] = leaf.phys
            h.oldptr[rphys] = leaf.phys
        self._relink_sibling(int(h.lsib[leaf.phys]), rsib=llid)
        self._relink_sibling(int(h.rsib[leaf.phys]), lsib=rlid)
        gc_slots.append(leaf.phys)
        gc_lids.append(leaf.lid)
        promoted = (items[mid][0], rlid)
        new_left_lid = llid
        child = leaf

        # --- full interior ancestors ----------------------------------------
        for e in split_levels[1:]:
            it = self._patch_child(self._interior_items(e.phys),
                                   child.slot_in_parent, new_left_lid,
                                   promoted)
            left0 = (new_left_lid if child.slot_in_parent == -1
                     else int(h.left_child[e.phys]))
            # after patching, items may start with the promoted entry when the
            # child came via left_child; recompute cleanly:
            mid_i = len(it) // 2
            mk, mchild = it[mid_i]
            lp, rp = h.alloc(), h.alloc()
            self._fill_interior(lp, left0, it[:mid_i], wv)
            self._fill_interior(rp, mchild, it[mid_i + 1:], wv)
            llid2, rlid2 = self.pt.alloc_lid(lp), self.pt.alloc_lid(rp)
            gc_slots.append(e.phys)
            gc_lids.append(e.lid)
            promoted = (mk, rlid2)
            new_left_lid = llid2
            child = e

        # --- root of the split ------------------------------------------------
        if root_of_split is None:
            new_root = h.alloc()   # grow the tree
            self._fill_interior(new_root, new_left_lid, [promoted], wv)
            if c.mvcc:  # old-read-version walks enter the pre-growth subtree
                h.oldptr[new_root] = child.phys
            self.root_lid = self.pt.alloc_lid(new_root)
            self.height += 1
            self.stats.grows += 1
        else:
            e = root_of_split
            it = self._patch_child(self._interior_items(e.phys),
                                   child.slot_in_parent, new_left_lid,
                                   promoted)
            left0 = (new_left_lid if child.slot_in_parent == -1
                     else int(h.left_child[e.phys]))
            swap = h.alloc()       # N_swap: new buffer, same LID (Fig. 4b)
            self._fill_interior(swap, left0, it, wv)
            if c.mvcc:
                h.oldptr[swap] = e.phys
            self.pt.remap(e.lid, swap)   # Fig. 4c: atomic subtree swap
            gc_slots.append(e.phys)
            h.unlock_bump(e.phys)

        for e in split_levels[1:]:
            h.unlock_bump(e.phys)
        h.unlock_bump(leaf.phys)
        self.gc.defer(slots=gc_slots, lids=gc_lids)
        self.versions.release(wv)
        self.stats.splits += 1

    @staticmethod
    def _patch_child(items: list[tuple[bytes, int]], slot: int,
                     new_left_lid: int,
                     promoted: tuple[bytes, int]) -> list[tuple[bytes, int]]:
        """Re-point the split child's entry at the left half and insert the
        promoted (boundary key, right half) item after it."""
        out = list(items)
        if slot >= 0:
            out[slot] = (out[slot][0], new_left_lid)
            out.insert(slot + 1, promoted)
        else:
            # child was the left_child; caller re-points left_child
            out.insert(0, promoted)
        return out

    def _relink_sibling(self, lid: int, lsib: int | None = None,
                        rsib: int | None = None):
        """Paper: lock the adjacent leaf and update its sibling pointer in
        place (the only in-place mutation besides the log fast path)."""
        if lid == NULL:
            return
        phys = self.pt.lookup(lid)
        ok = self.heap.try_lock(phys, self.heap.seqno(phys))
        assert ok, "sibling lock contention impossible on one host thread"
        if lsib is not None:
            self.heap.lsib[phys] = lsib
        if rsib is not None:
            self.heap.rsib[phys] = rsib
        self.heap.mark_dirty(phys)
        self.heap.unlock_bump(phys)

    # -------------------------------------------------------- underflow merge
    def _underflow(self, path: list[_PathEntry], items):
        """Merge an underfull leaf with its right sibling under the same
        parent when the result fits; otherwise plain rebuild."""
        c, h = self.cfg, self.heap
        leaf, parent = path[-1], path[-2]
        right_slot = leaf.slot_in_parent + 1
        if right_slot >= int(h.nitems[parent.phys]):
            self._rebuild_leaf(path, items)
            return
        rlid = int(h.svals[parent.phys, right_slot, 0])
        rphys = self.pt.lookup(rlid)
        if (int(h.nlog[rphys]) > 0
                or len(items) + int(h.nitems[rphys]) > c.node_cap):
            self._rebuild_leaf(path, items)
            return
        locked = []
        for p, s in ((parent.phys, parent.seqno),
                     (rphys, self.heap.seqno(rphys))):
            if not self.heap.try_lock(p, s):
                for q in locked:
                    h.unlock(q)
                h.unlock(leaf.phys)
                self.stats.restarts += 1
                raise _Restart()
            locked.append(p)

        wv = self.versions.acquire_write_version()
        r_items = [(self._key_bytes(h.skeys[rphys, i],
                                    int(h.skeylen[rphys, i])),
                    h.svals[rphys, i].copy(), int(h.svallen[rphys, i]))
                   for i in range(int(h.nitems[rphys]))]
        newp = h.alloc()
        self._fill_leaf(newp, items + r_items, wv)
        h.lsib[newp] = h.lsib[leaf.phys]
        h.rsib[newp] = h.rsib[rphys]
        if c.mvcc:
            h.oldptr[newp] = leaf.phys
        # the parent loses the separator of the right sibling
        it = self._interior_items(parent.phys)
        del it[right_slot]
        swap = h.alloc()
        self._fill_interior(swap, int(h.left_child[parent.phys]), it, wv)
        if c.mvcc:
            h.oldptr[swap] = parent.phys
        self.pt.remap(leaf.lid, newp)
        self.pt.remap(parent.lid, swap)
        self._relink_sibling(int(h.rsib[rphys]), lsib=leaf.lid)
        h.unlock_bump(rphys)
        h.unlock_bump(parent.phys)
        h.unlock_bump(leaf.phys)
        self.gc.defer(slots=(leaf.phys, rphys, parent.phys), lids=(rlid,))
        self.versions.release(wv)
        self.stats.node_merges += 1

    # ------------------------------------------------------------- validation
    def check_invariants(self):
        """Structural invariants exercised by property tests."""
        leaves: list[int] = []
        self._check_node(self.root_lid, None, None, self.height, leaves)
        # leaf sibling chain is consistent left-to-right
        for a, b in zip(leaves, leaves[1:]):
            pa, pb = self.pt.lookup(a), self.pt.lookup(b)
            assert int(self.heap.rsib[pa]) == b, "broken rsib chain"
            assert int(self.heap.lsib[pb]) == a, "broken lsib chain"

    def _check_node(self, lid: int, lo, hi, levels_left: int, leaves: list):
        h = self.heap
        phys = self.pt.lookup(lid)
        assert phys != NULL, f"dangling LID {lid}"
        n = int(h.nitems[phys])
        keys = [self._key_bytes(h.skeys[phys, i], int(h.skeylen[phys, i]))
                for i in range(n)]
        assert keys == sorted(keys), "sorted block out of order"
        for k in keys:
            assert lo is None or k >= lo, "key below subtree bound"
            assert hi is None or k < hi, "key above subtree bound"
        if int(h.ntype[phys]) == INTERIOR:
            assert levels_left > 1, "interior node at leaf level"
            children = [(int(h.left_child[phys]), lo, keys[0] if n else hi)]
            for i in range(n):
                children.append((int(h.svals[phys, i, 0]), keys[i],
                                 keys[i + 1] if i + 1 < n else hi))
            for child, clo, chi in children:
                self._check_node(child, clo, chi, levels_left - 1, leaves)
        else:
            assert levels_left == 1, "leaf above leaf level"
            assert not self.heap.is_locked(phys), "leaf left locked"
            leaves.append(lid)

    def __len__(self):
        """Live item count (full scan) — test helper."""
        return len(self.scan(b"", b"\xff" * self.cfg.max_key_bytes,
                             read_version=self.versions.global_write_version))
