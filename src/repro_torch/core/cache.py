"""Interior-node cache + load balancer (paper Section 5), port of
``repro.core.cache``.

On the FPGA the cache moves interior-node reads from PCIe (slow) to on-board
DRAM (fast), the root lives in on-chip SRAM, and a load balancer sends some
cache *hits* back to PCIe when DRAM is saturated so that the two off-chip
pipes are both busy.

Here that tiering runs on device, end to end.  At every snapshot export
``refresh`` walks the root + top ``cfg.cache_levels`` interior levels
breadth-first and ``device_lids`` emits them as a NULL-padded LID vector
that rides on ``TreeSnapshot.cache_lids`` (~KB on the sync feeds);
``attach_cache_image`` (core/read_path.py) rebuilds the contiguous
``[cache_slots, image_words]`` cache array from the resident heap image
wherever a snapshot is staged.  The fused read kernel
(kernels/fused_read.py) resolves every cached level from that array with
no pagetable lookup and no MVCC walk; levels below the
cached frontier fall through to the heap path, and ``cfg.lb_fraction``
deterministically routes a slice of cache-HIT lanes down the heap pipe
anyway (the Section 5 dual-pipe trick — identical results, different byte
split).  The device pipes are metered on ``CacheStats`` as
``vmem_hits`` / ``heap_gathers`` / ``lb_routed`` (the reference's names:
on the GPU a "vmem hit" is a level served from the cache array, which
stays in device memory and L2).

The host side of the structure remains: a set-associative metadata table
keyed by LID, refreshed at export, invalidated when the page table remaps
or frees a LID (Section 5: "the cache entry for the node with that LID is
invalidated" — wired via ``PageTable.on_remap``), plus the host load
balancer ``route`` (``cfg.load_balance``/``lb_fast_fraction``) with its
fast/slow read and byte meters, the model the reference's benchmarks use
for the Fig. 16 hit-rate/byte-split curves.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..analysis import epochsan as _epochsan
from .config import HoneycombConfig
from .heap import INTERIOR, NULL
from .telemetry import samples_from


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0
    fast_path_reads: int = 0     # served from the packed cache ("DRAM")
    slow_path_reads: int = 0     # routed to the heap ("PCIe")
    fast_bytes: int = 0
    slow_bytes: int = 0
    # device read-path meters (fused kernel, kernels/fused_read.py):
    # per-level lookups resolved from the cache array, from the
    # heap image, and the cache HITS the lb_fraction balancer routed down
    # the heap pipe anyway (lb_routed is a subset of heap_gathers)
    vmem_hits: int = 0
    heap_gathers: int = 0
    lb_routed: int = 0

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    @property
    def device_hit_rate(self) -> float:
        t = self.vmem_hits + self.heap_gathers
        return self.vmem_hits / t if t else 0.0

    def collect(self):
        """Registry samples (core/telemetry.py collect protocol):
        ``cache_*`` counters plus the two hit-rate gauges."""
        return samples_from(self, "cache", "cache",
                            derived=("hit_rate", "device_hit_rate"))


class InteriorCache:
    """4-way set-associative cache of interior nodes, indexed by LID."""

    def __init__(self, cfg: HoneycombConfig):
        self.cfg = cfg
        self.sets = max(1, cfg.cache_slots // cfg.cache_ways)
        self.tag = np.full((self.sets, cfg.cache_ways), NULL, np.int64)
        self.phys = np.full((self.sets, cfg.cache_ways), NULL, np.int64)
        self.tick = np.zeros((self.sets, cfg.cache_ways), np.int64)
        self._clock = 0
        self._rng = np.random.default_rng(0)
        self.stats = CacheStats()
        # packed top-level image: lids present, order = packed slot index
        self.packed_lids: np.ndarray = np.zeros((0,), np.int64)

    def _set_of(self, lid: int) -> int:
        return lid % self.sets

    def lookup(self, lid: int, phys: int) -> bool:
        """Metadata-table probe (Section 5).  A hit requires the cached
        physical address to match the live page table (the NAT check);
        mismatches count as misses and invalidate the way."""
        s = self._set_of(lid)
        self._clock += 1
        for w in range(self.cfg.cache_ways):
            if self.tag[s, w] == lid:
                if self.phys[s, w] != phys:
                    self.tag[s, w] = NULL
                    self.stats.invalidations += 1
                    break
                self.tick[s, w] = self._clock
                self.stats.hits += 1
                return True
        self.stats.misses += 1
        self._fill(lid, phys)
        return False

    def _fill(self, lid: int, phys: int):
        """Write-back on miss; random eviction within the set (the paper
        leaves smarter policies to future work)."""
        s = self._set_of(lid)
        for w in range(self.cfg.cache_ways):
            if self.tag[s, w] == NULL:
                self.tag[s, w], self.phys[s, w] = lid, phys
                self.tick[s, w] = self._clock
                return
        w = int(self._rng.integers(self.cfg.cache_ways))
        self.tag[s, w], self.phys[s, w] = lid, phys
        self.tick[s, w] = self._clock

    def invalidate(self, lid: int):
        san = _epochsan.get()
        if san is not None:   # a remap happened: the NEXT staging must
            san.note_cache_invalidate(self)   # refresh before it ships
        s = self._set_of(lid)
        for w in range(self.cfg.cache_ways):
            if self.tag[s, w] == lid:
                self.tag[s, w] = NULL
                self.stats.invalidations += 1

    # ------------------------------------------------------- top-level pack
    def frontier_lids(self, tree) -> list[int]:
        """Breadth-first LIDs of the root + top ``cfg.cache_levels`` tree
        levels (level 0 = the root — the paper's SRAM tier; deeper levels
        the DRAM tier), capped at ``cache_slots``.  Trees shorter than the
        level budget just yield every node they have down to the leaves."""
        cap = self.cfg.cache_slots
        lids = [tree.root_lid]
        level = [tree.root_lid]
        for _ in range(self.cfg.cache_levels - 1):
            nxt: list[int] = []
            for lid in level:
                phys = tree.pt.lookup(lid)
                if int(tree.heap.ntype[phys]) != INTERIOR:
                    continue
                nxt.append(int(tree.heap.left_child[phys]))
                for i in range(int(tree.heap.nitems[phys])):
                    nxt.append(int(tree.heap.svals[phys, i, 0]))
            if not nxt or len(lids) + len(nxt) > cap:
                break       # never cache a partial level: membership must
            lids.extend(nxt)  # be decidable from the LID vector alone
            level = nxt
        return lids[:cap]

    def refresh(self, tree):
        """Rebuild the packed top-level frontier at snapshot export; the
        fused read kernel receives its image rows as the snapshot's cache
        array (``TreeSnapshot.cache_lids`` / ``cache_image``)."""
        self.packed_lids = np.asarray(self.frontier_lids(tree), np.int64)
        for lid in self.packed_lids:
            self.lookup(int(lid), tree.pt.lookup(int(lid)))
        san = _epochsan.get()
        if san is not None:
            san.note_cache_refresh(self)

    def device_lids(self, tree=None) -> np.ndarray:
        """The packed frontier as the fixed-shape i32 vector that rides on
        ``TreeSnapshot.cache_lids``: ``refresh``'s LIDs, NULL-padded to
        ``cache_slots`` (refreshes the frontier first when a tree is
        given)."""
        if tree is not None:
            self.refresh(tree)
        out = np.full((self.cfg.cache_slots,), NULL, np.int32)
        out[: len(self.packed_lids)] = self.packed_lids
        return out

    # ----------------------------------------------------- load balancer
    def route(self, lid: int, phys: int, nbytes: int,
              fast_inflight: int = 0, slow_inflight: int = 0) -> str:
        """Load-balanced read routing (Section 5).  Returns 'fast' (cache)
        or 'slow' (heap/PCIe).  Balances by inflight bytes when telemetry is
        supplied, else by the configured fraction."""
        hit = self.lookup(lid, phys)
        if not hit:
            path = "slow"
        elif not self.cfg.load_balance:
            path = "fast"
        elif fast_inflight or slow_inflight:
            path = "fast" if fast_inflight <= slow_inflight else "slow"
        else:
            path = "fast" if self._rng.random() < self.cfg.lb_fast_fraction \
                else "slow"
        if path == "fast":
            self.stats.fast_path_reads += 1
            self.stats.fast_bytes += nbytes
        else:
            self.stats.slow_path_reads += 1
            self.stats.slow_bytes += nbytes
        return path
