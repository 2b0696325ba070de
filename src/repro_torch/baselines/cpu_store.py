"""Software-only ordered key-value store, the eRPC-Masstree stand-in (port
of ``repro.baselines.cpu_store``).

The paper's baseline (Section 6) is Masstree behind eRPC: a cache-crafted
in-memory trie/B+tree run entirely on CPU cores.  This is a plain store
with the same interface as ``HoneycombStore``: sorted leaves of at most
``node_cap`` items under a sorted list of leaf minimums (no shortcuts, no
log blocks, no MVCC, no device path; every operation is a host operation
touching whole nodes).  The benchmarks meter *bytes touched* and
operations per second, so that the Honeycomb-against-CPU comparison has
the paper's shape.

One difference from the reference, in how a leaf is found, and none in
what is answered or metered.  The reference rebuilds the list of every
leaf's minimum on each lookup and finds a leaf's position with
``leaves.index``, so each GET, PUT, DELETE and SCAN costs O(leaves): its
throughput falls as the store grows, which Masstree's (logarithmic)
lookup does not.  Here the list of minimums is kept up to date in place
(a put or a delete at a leaf's position 0, a split, a leaf's removal) and
the leaf's position comes from the same bisect over it.  Answers, leaf
contents and every ``CpuStoreStats`` field equal the reference's on any
op sequence: ``node_visits`` counts one visit a lookup and one a leaf a
scan walks, ``bytes_touched`` the key and value bytes of the same leaves.
"""
from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class CpuStoreStats:
    gets: int = 0
    puts: int = 0
    deletes: int = 0
    scans: int = 0
    bytes_touched: int = 0
    node_visits: int = 0

    def collect(self):
        """Registry samples (core/telemetry.py collect protocol):
        ``cpu_store_*`` counters for the host-baseline op mix."""
        from ..core.telemetry import samples_from
        return samples_from(self, "cpu_store", "baseline")


class _Leaf:
    __slots__ = ("keys", "vals", "next")

    def __init__(self):
        self.keys: list[bytes] = []
        self.vals: list[bytes] = []
        self.next: _Leaf | None = None


class CpuOrderedStore:
    """Sorted leaves chained left to right, found by a bisect over their
    minimums.  Node capacity mirrors Honeycomb's ``node_cap``."""

    def __init__(self, node_cap: int = 64):
        self.node_cap = node_cap
        self.leaves: list[_Leaf] = [_Leaf()]
        # each leaf's first key (b"" for the one leaf of an empty store),
        # in leaf order: what the reference rebuilds on every lookup
        self._mins: list[bytes] = [b""]
        self.stats = CpuStoreStats()

    # a two-level structure: a sorted list of leaf minimums (a fanout-free
    # interior), which is what Masstree's upper trie amortizes to for random
    # keys; adequate as a throughput baseline
    def _find_leaf(self, key: bytes) -> tuple[int, _Leaf]:
        """The leaf that holds ``key`` or would, and its position."""
        self.stats.node_visits += 1
        pos = max(bisect.bisect_right(self._mins, key) - 1, 0)
        return pos, self.leaves[pos]

    def put(self, key: bytes, val: bytes):
        self.stats.puts += 1
        pos, lf = self._find_leaf(key)
        i = bisect.bisect_left(lf.keys, key)
        self.stats.bytes_touched += sum(map(len, lf.keys)) \
            + sum(map(len, lf.vals))
        if i < len(lf.keys) and lf.keys[i] == key:
            lf.vals[i] = val
        else:
            lf.keys.insert(i, key)
            lf.vals.insert(i, val)
            if i == 0:
                self._mins[pos] = key
            if len(lf.keys) > self.node_cap:
                self._split(pos, lf)

    update = put

    def _split(self, pos: int, lf: _Leaf):
        mid = len(lf.keys) // 2
        right = _Leaf()
        right.keys, right.vals = lf.keys[mid:], lf.vals[mid:]
        lf.keys, lf.vals = lf.keys[:mid], lf.vals[:mid]
        right.next, lf.next = lf.next, right
        self.leaves.insert(pos + 1, right)
        self._mins.insert(pos + 1, right.keys[0])

    def delete(self, key: bytes):
        self.stats.deletes += 1
        pos, lf = self._find_leaf(key)
        i = bisect.bisect_left(lf.keys, key)
        self.stats.bytes_touched += sum(map(len, lf.keys))
        if i < len(lf.keys) and lf.keys[i] == key:
            del lf.keys[i], lf.vals[i]
            if not lf.keys and len(self.leaves) > 1:
                if pos > 0:
                    self.leaves[pos - 1].next = lf.next
                del self.leaves[pos], self._mins[pos]
            elif i == 0:
                self._mins[pos] = lf.keys[0] if lf.keys else b""

    def get(self, key: bytes) -> bytes | None:
        self.stats.gets += 1
        _, lf = self._find_leaf(key)
        self.stats.bytes_touched += sum(map(len, lf.keys))
        i = bisect.bisect_left(lf.keys, key)
        if i < len(lf.keys) and lf.keys[i] == key:
            self.stats.bytes_touched += len(lf.vals[i])
            return lf.vals[i]
        return None

    def scan(self, lo: bytes, hi: bytes,
             max_items: int | None = None) -> list[tuple[bytes, bytes]]:
        """Floor-start scan with Honeycomb-compatible semantics: the
        largest key <= lo, then every key in (lo, hi], in order."""
        self.stats.scans += 1
        out: list[tuple[bytes, bytes]] = []
        pos, lf = self._find_leaf(lo)
        # floor: the largest key <= lo (may sit in an earlier leaf)
        for j in range(pos, -1, -1):
            keys = self.leaves[j].keys
            self.stats.bytes_touched += sum(map(len, keys))
            f = bisect.bisect_right(keys, lo)
            if f:
                out.append((keys[f - 1], self.leaves[j].vals[f - 1]))
                break
        node: _Leaf | None = lf
        while node is not None:
            self.stats.node_visits += 1
            self.stats.bytes_touched += sum(map(len, node.keys)) \
                + sum(map(len, node.vals))
            for k, v in zip(node.keys, node.vals):
                if k <= lo:
                    continue
                if k > hi:
                    return out
                out.append((k, v))
                if max_items and len(out) >= max_items:
                    return out
            node = node.next
        return out

    # batch facades for benchmark parity with HoneycombStore
    def get_batch(self, keys):
        return [self.get(k) for k in keys]

    def scan_batch(self, ranges):
        return [self.scan(lo, hi) for lo, hi in ranges]
