"""Paged KV cache whose page table IS a Honeycomb ordered store (port of
``repro.serving.kv_cache``).

The paper's read/write split maps onto serving:
  * page-table reads (decode-time batched lookups of (seq, block) -> page)
    run on the device path — one fused GET batch (``get_batch``);
  * page allocation and free (scheduler decisions) are host-side writes
    (PUT/DELETE), the CPU half of the paper;
  * the prefix cache uses SCAN's floor semantics: keys are rolling-hash
    chains of token prefixes, and "longest cached prefix of this prompt"
    is ``largest key <= K``.

Keys: 16-byte big-endian (seq_id u64, block_idx u64) for pages;
      (hash u64, length u64) for prefixes.  Values: 4-byte page ids.
Both stores keep their snapshots on ``device`` (``"cuda"`` unless the
caller passes ``"cpu"``).

Given a span ring (``spans``, core/telemetry.py), the page table's calls
record spans: ``page_table.put`` (a page allocated), ``page_table.reserve``
(a decode step's page check, a host GET a row), ``page_table.lookup``
(the block-table GET) with its children ``page_table.export`` (the
``on_read`` delta sync) and ``page_table.get`` (the GET batch and its
result copies), and ``page_table.free``.  Each carries its host PUTs,
GETs and DELETEs in ``tags``; the table's own ``stats``, ``sync_stats``
and ``pipeline_stats`` keep the totals.
"""
from __future__ import annotations

import numpy as np

from ..core import HoneycombConfig, HoneycombStore
from ..core.telemetry import SpanRing, span


def page_key(seq_id: int, block: int) -> bytes:
    return int(seq_id).to_bytes(8, "big") + int(block).to_bytes(8, "big")


def prefix_key(h: int, length: int) -> bytes:
    return int(h & (2 ** 64 - 1)).to_bytes(8, "big") \
        + int(length).to_bytes(8, "big")


def rolling_hashes(tokens: np.ndarray, block: int) -> list[tuple[int, int]]:
    """[(hash, n_tokens)] for every block-aligned prefix (FNV-1a over the
    tokens' low 32 bits)."""
    out = []
    h = np.uint64(1469598103934665603)          # FNV offset
    prime = np.uint64(1099511628211)
    with np.errstate(over="ignore"):
        for i, t in enumerate(tokens.tolist()):
            h = np.uint64(h ^ np.uint64(t & 0xFFFFFFFF)) * prime
            if (i + 1) % block == 0:
                out.append((int(h), i + 1))
    return out


def _store_config() -> HoneycombConfig:
    return HoneycombConfig(node_cap=64, log_cap=16, n_shortcuts=8,
                           key_words=4)


class PagedKVCache:
    """Physical page pool + Honeycomb page table."""

    def __init__(self, n_pages: int, page_size: int,
                 cfg: HoneycombConfig | None = None, device="cuda",
                 spans: SpanRing | None = None):
        self.n_pages = n_pages
        self.page_size = page_size
        self.free_pages = list(range(n_pages - 1, -1, -1))
        self.table = HoneycombStore(cfg or _store_config(), device=device)
        self.prefix = HoneycombStore(_store_config(), device=device)
        self.spans = spans

    # ------------------------------------------------------- allocation
    def allocate(self, seq_id: int, block: int) -> int:
        """Host-side write (the paper's CPU PUT)."""
        with span(self.spans, "page_table.put", rid=seq_id, puts=1):
            if not self.free_pages:
                raise RuntimeError("KV pool exhausted")
            page = self.free_pages.pop()
            self.table.put(page_key(seq_id, block),
                           int(page).to_bytes(4, "big"))
        return page

    def reserve(self, blocks: list[tuple[int, int]]):
        """A page for each (seq_id, block): a host GET each, and a PUT
        where the block has none yet."""
        with span(self.spans, "page_table.reserve", gets=len(blocks)) as sp:
            puts = 0
            for seq_id, block in blocks:
                if self.table.get(page_key(seq_id, block)) is None:
                    self.allocate(seq_id, block)
                    puts += 1
            sp.tag(puts=puts)

    def free_seq(self, seq_id: int, n_blocks: int):
        with span(self.spans, "page_table.free", rid=seq_id,
                  gets=n_blocks) as sp:
            freed = 0
            for b in range(n_blocks):
                k = page_key(seq_id, b)
                v = self.table.get(k)
                if v is not None:
                    self.table.delete(k)
                    self.free_pages.append(int.from_bytes(v, "big"))
                    freed += 1
            sp.tag(deletes=freed)

    # ----------------------------------------------------- batched reads
    def lookup_block_tables(self, seq_ids: list[int], n_blocks: int
                            ) -> np.ndarray:
        """Device-path batched GET: [len(seq_ids), n_blocks] int32.
        Missing blocks map to page 0 (masked off by seq_lens downstream).
        The table's ``get_batch`` in its two halves, each its own span:
        the sync its policy runs before a read, then the GET batch."""
        keys = [page_key(s, b) for s in seq_ids for b in range(n_blocks)]
        table, sync = self.table, self.table.sync_stats
        with span(self.spans, "page_table.lookup", keys=len(keys)) as sp:
            rows, nbytes = sync.delta_rows, sync.bytes_synced
            with span(self.spans, "page_table.export") as ex:
                snap = table.snapshot_for_read()
                ex.tag(rows=sync.delta_rows - rows,
                       bytes=sync.bytes_synced - nbytes)
            lanes = table.pipeline_stats.padded_lanes
            with span(self.spans, "page_table.get"):
                vals = table.get_batch(keys, snap)
            sp.tag(padded=table.pipeline_stats.padded_lanes - lanes
                   - len(keys))
            out = np.array([int.from_bytes(v, "big") if v is not None
                            else 0 for v in vals], np.int32)
        return out.reshape(len(seq_ids), n_blocks)

    # ------------------------------------------------------ prefix cache
    def register_prefix(self, tokens: np.ndarray, seq_id: int):
        """Record every block-aligned prefix of a finished prompt."""
        for h, ln in rolling_hashes(tokens, self.page_size):
            self.prefix.put(prefix_key(h, ln),
                            int(seq_id).to_bytes(8, "big"))

    def longest_cached_prefix(self, tokens: np.ndarray) -> tuple[int, int]:
        """(source seq_id, n_tokens) of the longest cached prefix, or
        (-1, 0).  Floor-SCAN per candidate hash, longest first."""
        for h, ln in reversed(rolling_hashes(tokens, self.page_size)):
            key = prefix_key(h, ln)
            for k, v in self.prefix.scan_batch([(key, key)])[0]:
                if k == key:
                    return int.from_bytes(v, "big"), ln
        return -1, 0

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self.free_pages)
