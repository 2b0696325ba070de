"""Batched wait-free GET/SCAN in plain PyTorch (port of
``repro.core.read_path``).

This is the interior-node search engine (KSU) and the leaf scan engine
(RSU) of the paper's accelerator written as batched tensor code.  It is
the plain version the hand-written kernels are held to
(``kernels/ref.py`` composes the fused oracles from it), the CPU backend
of the port, and the ``read_backend="reference"`` path on any device.

  * request-level parallelism  -> the batch dimension B (every lane is an
    independent request).
  * KSU shortcut search        -> read ONLY the shortcut block, then ONLY
    the selected sorted-block segment.
  * wait-free MVCC reads       -> bounded old-version chain walk against an
    immutable snapshot (a request never observes a half-swapped node).
  * RSU order-hint log sort    -> shift-register positions, no key
    comparisons (Section 4.3, Figs. 7-8).
  * merged emission            -> ranks from back pointers + hint order;
    equal keys come out adjacent and resolve to the newest visible version
    (delete markers drop the key).

Every tensor is int32 (bool for masks): key and value lanes are the int32
bit views of their u32 words (core/keys.py), and results keep the
reference's dtypes bit for bit.  Versions are int32 on the device; the
host keeps the authoritative 64-bit counters.  Gathers with a NULL (-1)
index wrap to the last row exactly as the reference's do; such lanes are
always masked out of the results.

Snapshot layouts: the default device-resident representation is the
PACKED node image (core/schema.py), one ``[S, image_words]`` tensor with
every per-node field at a static word offset.  The per-field
representation (``cfg.layout="legacy"``) survives as
``LegacyTreeSnapshot``/``LegacySnapshotDelta``: one tensor per field, each
dirty row shipped as 24 per-field blocks.  All search and scan code reads
fields through ``snapshot_fields()``, which slices packed images at the
layout's offsets and passes legacy snapshots through untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import HoneycombConfig
from .heap import LEAF, LOG_DELETE, NULL
from .keys import torch_key_cmp
from .schema import FIELD_NAMES, NodeImageLayout

INT32_MAX = 2 ** 31 - 1
INT32_MIN = -(2 ** 31)


class TreeSnapshot(NamedTuple):
    """Immutable device image of the store: ONE packed node-image tensor
    (every per-node field at its static layout offset — core/schema.py)
    plus the page table and the two sync scalars, kept on the host as
    Python ints.

    ``cache_lids``/``cache_image`` are the device cache tier (paper
    Section 5): the root + top interior levels packed contiguously.  Only
    ``cache_lids`` is shipped at a sync; ``cache_image`` is rebuilt on the
    device from the resident image by ``attach_cache_image``, so its rows
    are bit-identical to the version-resolved heap rows."""
    image: torch.Tensor         # i32 [S, image_words] packed node images
    pagetable: torch.Tensor     # i32 [LIDS]
    root_lid: int
    read_version: int
    cache_lids: torch.Tensor | None = None    # i32 [C], NULL-padded
    cache_image: torch.Tensor | None = None   # i32 [C, image_words]


class LegacyTreeSnapshot(NamedTuple):
    """Per-field device image (the pre-packing layout, cfg.layout="legacy"):
    one int32 tensor per node field (u32 fields as their bit views), kept
    as the packed layout's op-for-op parity reference.  It carries no
    cache tier, so it is read through the ``"reference"`` path."""
    ntype: torch.Tensor        # i32 [S]
    nitems: torch.Tensor       # i32 [S]
    version: torch.Tensor      # i32 [S]
    oldptr: torch.Tensor       # i32 [S]
    left_child: torch.Tensor   # i32 [S]
    lsib: torch.Tensor         # i32 [S]
    rsib: torch.Tensor         # i32 [S]
    skeys: torch.Tensor        # i32 [S, N, KW] (u32 bit views)
    skeylen: torch.Tensor      # i32 [S, N]
    svals: torch.Tensor        # i32 [S, N, VW] (u32 bit views)
    svallen: torch.Tensor      # i32 [S, N]
    n_shortcuts: torch.Tensor  # i32 [S]
    sc_keys: torch.Tensor      # i32 [S, NSC, KW] (u32 bit views)
    sc_keylen: torch.Tensor    # i32 [S, NSC]
    sc_pos: torch.Tensor       # i32 [S, NSC]
    nlog: torch.Tensor         # i32 [S]
    log_keys: torch.Tensor     # i32 [S, L, KW] (u32 bit views)
    log_keylen: torch.Tensor   # i32 [S, L]
    log_vals: torch.Tensor     # i32 [S, L, VW] (u32 bit views)
    log_vallen: torch.Tensor   # i32 [S, L]
    log_op: torch.Tensor       # i32 [S, L]
    log_backptr: torch.Tensor  # i32 [S, L]
    log_hint: torch.Tensor     # i32 [S, L]
    log_vdelta: torch.Tensor   # i32 [S, L]
    pagetable: torch.Tensor    # i32 [LIDS]
    root_lid: int
    read_version: int


# per-node-row snapshot fields, in layout order — derived from the ONE
# schema (core/schema.py), not re-enumerated
NODE_FIELDS = FIELD_NAMES


class SnapshotFields:
    """Per-field view of a packed snapshot: each attribute is a static
    column slice of the image (no copy), shaped per node."""
    __slots__ = FIELD_NAMES + ("pagetable", "root_lid", "read_version")

    def __init__(self, **fields):
        for k, v in fields.items():
            object.__setattr__(self, k, v)


def snapshot_fields(snap, cfg: HoneycombConfig):
    """Adapt any snapshot (packed, legacy, or an existing view) to
    per-field attribute access; legacy snapshots pass through."""
    if isinstance(snap, TreeSnapshot):
        layout = NodeImageLayout.for_config(cfg)
        return SnapshotFields(pagetable=snap.pagetable,
                              root_lid=snap.root_lid,
                              read_version=snap.read_version,
                              **layout.field_views(snap.image))
    return snap


def attach_cache_image(snap: TreeSnapshot, cfg: HoneycombConfig):
    """(Re)build the snapshot's contiguous cache tier from its own heap
    image: one version-resolved image row per cached LID, zeros in the
    NULL-padded slots.  Called wherever a snapshot is staged, so the
    cache rows always equal the heap rows the reference path resolves
    (the invariant fused ≡ reference rests on)."""
    if snap.cache_lids is None:
        return snap
    view = snapshot_fields(snap, cfg)
    lids = snap.cache_lids
    phys = snap.pagetable[lids.clamp(min=0)]
    phys = _resolve_version(view, phys.clamp(min=0), snap.read_version, cfg)
    rows = torch.where((lids != NULL)[:, None], snap.image[phys], 0)
    return snap._replace(cache_image=rows)


class SnapshotDelta(NamedTuple):
    """One host->device sync's worth of changed state (paper Sections 3-4:
    node-buffer copies + batched page-table commands + read-version
    update).  ``image`` carries each dirty node's ENTIRE packed image row.
    Rows may repeat (padding to a power-of-two size); repeated rows carry
    identical data, so the scatter is order-free."""
    rows: torch.Tensor       # i32 [D] dirty physical slots
    image: torch.Tensor      # i32 [D, image_words] replacement node images
    pt_lids: torch.Tensor    # i32 [P] page-table command targets
    pt_phys: torch.Tensor    # i32 [P] new mappings (may repeat, identical)
    root_lid: int
    read_version: int
    cache_lids: torch.Tensor | None = None  # i32 [C] next epoch's cache tier


class LegacySnapshotDelta(NamedTuple):
    """Per-field delta (cfg.layout="legacy"): one [D, ...] update block per
    node field — 24 blocks per dirty node, the traffic shape the packed
    layout collapses to one.  Rows may repeat with identical data."""
    rows: torch.Tensor         # i32 [D] dirty physical slots
    ntype: torch.Tensor        # i32 [D]
    nitems: torch.Tensor       # i32 [D]
    version: torch.Tensor      # i32 [D]
    oldptr: torch.Tensor       # i32 [D]
    left_child: torch.Tensor   # i32 [D]
    lsib: torch.Tensor         # i32 [D]
    rsib: torch.Tensor         # i32 [D]
    skeys: torch.Tensor        # i32 [D, N, KW]
    skeylen: torch.Tensor      # i32 [D, N]
    svals: torch.Tensor        # i32 [D, N, VW]
    svallen: torch.Tensor      # i32 [D, N]
    n_shortcuts: torch.Tensor  # i32 [D]
    sc_keys: torch.Tensor      # i32 [D, NSC, KW]
    sc_keylen: torch.Tensor    # i32 [D, NSC]
    sc_pos: torch.Tensor       # i32 [D, NSC]
    nlog: torch.Tensor         # i32 [D]
    log_keys: torch.Tensor     # i32 [D, L, KW]
    log_keylen: torch.Tensor   # i32 [D, L]
    log_vals: torch.Tensor     # i32 [D, L, VW]
    log_vallen: torch.Tensor   # i32 [D, L]
    log_op: torch.Tensor       # i32 [D, L]
    log_backptr: torch.Tensor  # i32 [D, L]
    log_hint: torch.Tensor     # i32 [D, L]
    log_vdelta: torch.Tensor   # i32 [D, L]
    pt_lids: torch.Tensor      # i32 [P] page-table command targets
    pt_phys: torch.Tensor      # i32 [P] new mappings (may repeat, identical)
    root_lid: int
    read_version: int


# the two legacy tuples spell the schema's field list out; hold them to it
assert LegacyTreeSnapshot._fields[:len(NODE_FIELDS)] == NODE_FIELDS
assert LegacySnapshotDelta._fields[1:1 + len(NODE_FIELDS)] == NODE_FIELDS


def apply_snapshot_delta(snap, delta, *, cfg: HoneycombConfig | None = None):
    """Scatter one sync's dirty rows + page-table commands into a copy of
    a resident snapshot, yielding the next snapshot.

    Functional on purpose: the input snapshot's tensors are never written,
    so old snapshots held by in-flight batches keep answering at their
    read version (wait-free MVCC).  Dispatches on the delta's layout:

      * packed ``SnapshotDelta`` — the image is cloned whole and the row
        scatter (``kernels/ops.snapshot_image_scatter``: the hand-written
        kernel on CUDA) patches the clone in place; the clone moves
        S·IW·4 bytes each way and dwarfs the scatter.  With ``cfg`` the
        cache tier is rebuilt from the patched image; without it the cache
        image is dropped rather than served stale, and a fused read of
        such a snapshot raises (``kernels/ops.py``); the reference read
        path still serves it.
      * ``LegacySnapshotDelta`` — the 24 field tensors are cloned and ONE
        multi-field scatter (``kernels/ops.snapshot_multi_scatter``)
        patches every field's dirty rows in the clones."""
    from ..kernels import ops  # deferred: kernels.ref imports this module
    pagetable = snap.pagetable.clone()
    pagetable[delta.pt_lids.long()] = delta.pt_phys
    if isinstance(delta, LegacySnapshotDelta):
        fields = {f: getattr(snap, f).clone() for f in NODE_FIELDS}
        S, D = snap.ntype.shape[0], delta.rows.shape[0]
        ops.snapshot_multi_scatter(
            [fields[f].view(S, -1) for f in NODE_FIELDS], delta.rows,
            [getattr(delta, f).reshape(D, -1) for f in NODE_FIELDS])
        return snap._replace(pagetable=pagetable, root_lid=delta.root_lid,
                             read_version=delta.read_version, **fields)
    image = snap.image.clone()
    ops.snapshot_image_scatter(image, delta.rows, delta.image)
    cache_lids = snap.cache_lids if delta.cache_lids is None \
        else delta.cache_lids
    nxt = snap._replace(image=image, pagetable=pagetable,
                        root_lid=delta.root_lid,
                        read_version=delta.read_version,
                        cache_lids=cache_lids)
    if cfg is not None:
        return attach_cache_image(nxt, cfg)
    return nxt._replace(cache_image=None)


class ScanResult(NamedTuple):
    count: torch.Tensor       # i32 [B] items emitted
    keys: torch.Tensor        # i32 [B, M, KW] (u32 bit views)
    keylens: torch.Tensor     # i32 [B, M]
    vals: torch.Tensor        # i32 [B, M, VW] (u32 bit views)
    vallens: torch.Tensor     # i32 [B, M]
    truncated: torch.Tensor   # bool [B] (ran out of result slots / leaves)


class GetResult(NamedTuple):
    found: torch.Tensor       # bool [B]
    vals: torch.Tensor        # i32 [B, VW] (u32 bit views)
    vallens: torch.Tensor     # i32 [B]


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


# --------------------------------------------------------------------------
# interior-node search engine (KSU)
# --------------------------------------------------------------------------

class RowTrace:
    """The rows a batch's walk reads ([rows] int32, 1 where read) and each
    request's count of dependent row reads ([B] int32), counted as the
    fused kernel counts its ``touched`` and ``loads``: a cached level is
    one read; a heap level, and each sibling leaf, is one for the
    page-table lookup and its row, plus one for each old-version hop.
    Only the lanes in the mask a step passes are counted."""

    def __init__(self, rows: int, B: int, device):
        self.touched = torch.zeros(rows, dtype=torch.int32, device=device)
        self.loads = torch.zeros(B, dtype=torch.int32, device=device)

    def read(self, phys: torch.Tensor, mask: torch.Tensor) -> None:
        """Mark row ``phys`` of each lane in ``mask`` (a negative row
        wraps once, then clamps, as the kernel indexes)."""
        n = self.touched.shape[0]
        r = torch.where(phys < 0, phys + n, phys).clamp(0, n - 1)
        self.touched[r[mask].long()] = 1

    def count(self, mask: torch.Tensor) -> None:
        """One more dependent row read for each lane in ``mask``."""
        self.loads += mask.to(torch.int32)


def _resolve_version(snap: SnapshotFields, phys: torch.Tensor, rv: int,
                     cfg: HoneycombConfig, trace: RowTrace | None = None,
                     live: torch.Tensor | None = None) -> torch.Tensor:
    """Follow old-version pointers until node version <= rv (Section 3.2).
    Bounded walk; wait-free (no locks, no retries).  ``trace`` records
    the rows the lanes in ``live`` read and their hops."""
    for _ in range(cfg.max_version_chain):
        old = snap.oldptr[phys]
        too_new = (snap.version[phys] > rv) & (old != NULL)
        if trace is not None:
            trace.read(phys, live)
            trace.count(live & too_new)
        phys = torch.where(too_new, old, phys)
    if trace is not None:
        trace.read(phys, live)
    return phys


def _shortcut_floor(snap: SnapshotFields, phys: torch.Tensor,
                    key: torch.Tensor, klen: torch.Tensor) -> torch.Tensor:
    """Largest shortcut index whose key <= query (0 if none: the query then
    falls below the first segment and the segment search yields -1)."""
    sck = snap.sc_keys[phys]          # [B, NSC, KW]
    scl = snap.sc_keylen[phys]        # [B, NSC]
    nsc = snap.n_shortcuts[phys]      # [B]
    c = torch_key_cmp(sck, scl, key[:, None, :], klen[:, None])
    ar = _arange(sck.shape[1], phys)[None, :]
    leq = (c <= 0) & (ar < nsc[:, None])
    idx = torch.where(leq, ar, -1).amax(dim=1)
    return idx.clamp(min=0)


def _segment_floor(snap: SnapshotFields, phys: torch.Tensor,
                   seg: torch.Tensor, key: torch.Tensor, klen: torch.Tensor,
                   cfg: HoneycombConfig) -> torch.Tensor:
    """Floor item index within the selected segment; -1 when the query is
    below every key in the node.  Reads ONLY the segment."""
    base = snap.sc_pos[phys, seg]                       # [B]
    ar = _arange(cfg.segment_items, phys)[None, :]
    offs = base[:, None] + ar
    offs_c = offs.clamp(max=cfg.node_cap - 1)
    seg_keys = snap.skeys[phys[:, None], offs_c]        # [B, seg, KW]
    seg_lens = snap.skeylen[phys[:, None], offs_c]
    valid = offs < snap.nitems[phys][:, None]
    c = torch_key_cmp(seg_keys, seg_lens, key[:, None, :], klen[:, None])
    local = torch.where((c <= 0) & valid, ar, -1).amax(dim=1)
    return torch.where(local >= 0, base + local, -1)


def _child(snap: SnapshotFields, cur: torch.Tensor, key: torch.Tensor,
           klen: torch.Tensor, cfg: HoneycombConfig) -> torch.Tensor:
    """Child LID an interior node routes the query to (left_child when the
    query is below every separator)."""
    seg = _shortcut_floor(snap, cur, key, klen)
    idx = _segment_floor(snap, cur, seg, key, klen, cfg)
    return torch.where(idx >= 0, snap.svals[cur, idx.clamp(min=0), 0],
                       snap.left_child[cur])


def descend(snap, key: torch.Tensor, klen: torch.Tensor,
            cfg: HoneycombConfig) -> torch.Tensor:
    """Traverse interior nodes root->leaf for a batch.  Returns the
    resolved physical slot of the leaf each request lands in."""
    snap = snapshot_fields(snap, cfg)
    B = key.shape[0]
    rv = snap.read_version
    lid = torch.full((B,), snap.root_lid, dtype=torch.int32,
                     device=key.device)
    phys = torch.zeros_like(lid)
    done = torch.zeros(B, dtype=torch.bool, device=key.device)
    for _ in range(cfg.max_height):
        cur = _resolve_version(snap, snap.pagetable[lid], rv, cfg)
        cur = torch.where(done, phys, cur)
        is_leaf = snap.ntype[cur] == LEAF
        child = _child(snap, cur, key, klen, cfg)
        done_next = done | is_leaf
        lid = torch.where(done_next, lid, child)
        phys, done = cur, done_next
    return phys


def fused_view(snap: TreeSnapshot, cfg: HoneycombConfig) -> SnapshotFields:
    """Field view over the heap image CONCATENATED with the snapshot's
    cache image: combined row indices >= S address cache rows.  Because
    cache rows equal their version-resolved heap rows, any search code on
    this view yields the same results whether a level resolved from the
    cache or the heap."""
    layout = NodeImageLayout.for_config(cfg)
    combined = torch.cat([snap.image, snap.cache_image], dim=0)
    return SnapshotFields(pagetable=snap.pagetable, root_lid=snap.root_lid,
                          read_version=snap.read_version,
                          **layout.field_views(combined))


def lb_routed_lanes(lane: torch.Tensor, lb_fraction: float) -> torch.Tensor:
    """Deterministic Section-5 dual-pipe routing: lanes whose index mod 16
    falls under round(lb_fraction * 16) send their cache-hit lookups down
    the heap pipe anyway (the kernel applies the same rule to its request
    index), so routing never perturbs results."""
    return (lane % 16) < int(round(lb_fraction * 16))


def descend_fused(snap: TreeSnapshot, view: SnapshotFields,
                  key: torch.Tensor, klen: torch.Tensor,
                  cfg: HoneycombConfig, *, lb_fraction: float = 0.0,
                  trace: RowTrace | None = None):
    """Cache-tiered descend (the fused path's plain version): a level whose
    LID is in the cache tier resolves straight to its cache row (combined
    index S + slot — no pagetable lookup, no MVCC walk), everything below
    the cached frontier falls through to the heap path, and an
    ``lb_fraction`` slice of cache-HIT lanes takes the heap pipe anyway.
    ``view`` must be ``fused_view(snap, cfg)``; ``trace``, when given,
    records the rows each level reads.

    Returns (leaf row in the combined view, meters i32[3] =
    [vmem_hits, heap_gathers, lb_routed] counted over traversed levels)."""
    S = snap.image.shape[0]
    clids = snap.cache_lids
    B = key.shape[0]
    rv = view.read_version
    lid = torch.full((B,), view.root_lid, dtype=torch.int32,
                     device=key.device)
    routed = lb_routed_lanes(_arange(B, key), lb_fraction)
    phys = torch.zeros_like(lid)
    done = torch.zeros(B, dtype=torch.bool, device=key.device)
    meters = torch.zeros(3, dtype=torch.int64, device=key.device)
    for _ in range(cfg.max_height):
        eq = clids[None, :] == lid[:, None]
        hit = eq.any(dim=1) & (lid != NULL)
        slot = eq.to(torch.uint8).argmax(dim=1).to(torch.int32)
        use_cache = hit & ~routed
        live = ~done
        heap_phys = _resolve_version(view, view.pagetable[lid], rv, cfg,
                                     trace, live & ~use_cache)
        if trace is not None:
            trace.read(S + slot, live & use_cache)
            trace.count(live)
        cur = torch.where(use_cache, S + slot, heap_phys)
        cur = torch.where(done, phys, cur)
        meters += torch.stack([(use_cache & live).sum(),
                               (~use_cache & live).sum(),
                               (hit & routed & live).sum()])
        is_leaf = view.ntype[cur] == LEAF
        child = _child(view, cur, key, klen, cfg)
        done_next = done | is_leaf
        lid = torch.where(done_next, lid, child)
        phys, done = cur, done_next
    return phys, meters.to(torch.int32)


# --------------------------------------------------------------------------
# leaf-node scan engine (RSU)
# --------------------------------------------------------------------------

def log_sort_positions(hints: torch.Tensor, nlog: torch.Tensor,
                       log_cap: int) -> torch.Tensor:
    """Shift-register sort of the log block using order hints (Fig. 8).

    hints: i32 [B, L]; returns pos [B, L] — the position of each log entry
    in ascending key order.  One vector step per entry, no key
    comparisons."""
    B, L = hints.shape
    del log_cap  # L is static from the shape
    ar = _arange(L, hints)[None, :]
    pos = torch.zeros_like(hints)
    for j in range(L):
        live = j < nlog
        shift = (ar < j) & live[:, None] & (pos >= hints[:, j][:, None])
        pos = pos + shift.to(pos.dtype)
        pos[:, j] = torch.where(live, hints[:, j], pos[:, j])
    return pos


def _take(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Reorder dim 1 of a [B, T, ...] tensor by a [B, T] permutation."""
    idx = order.reshape(order.shape + (1,) * (a.dim() - 2)).expand_as(a)
    return torch.gather(a, 1, idx)


def leaf_ranks(nitems: torch.Tensor, nlog: torch.Tensor,
               backptr: torch.Tensor, hints: torch.Tensor, node_cap: int,
               log_cap: int):
    """The RSU's merge keys of a batch of leaves: (rank [B, T] int32, used
    [B, T] bool) over the sorted block then the log block, T = node_cap +
    log_cap, from each leaf's nitems, nlog [B] and log back pointers and
    order hints [B, log_cap].  The stable order of ``rank`` is the leaf's
    ascending key order; unused slots rank INT32_MAX."""
    N, L = node_cap, log_cap
    B = nitems.shape[0]

    # --- RSU log sort via order hints -------------------------------------
    logpos = log_sort_positions(hints, nlog, L)                # [B, L]

    # merged rank: log entries go right before the sorted item their back
    # pointer names; hint order breaks ties among them (Section 4.3)
    rank_log = backptr * (L + 1) + logpos                      # [B, L]
    rank_sorted = (_arange(N, nitems) * (L + 1) + L)[None, :].expand(B, N)

    svis = _arange(N, nitems)[None, :] < nitems[:, None]
    lvis_slot = _arange(L, nitems)[None, :] < nlog[:, None]
    used = torch.cat([svis, lvis_slot], dim=1)
    rank = torch.where(used, torch.cat([rank_sorted, rank_log], dim=1),
                       INT32_MAX)
    return rank, used


def _resolve_leaf(snap: SnapshotFields, phys: torch.Tensor,
                  cfg: HoneycombConfig):
    """Merged, shadow-resolved enumeration of one leaf per request.

    Returns (keys [B,T,KW], keylens, vals [B,T,VW], vallens, live [B,T]) in
    ascending key order, where T = node_cap + log_cap.  ``live`` marks
    items that survive MVCC filtering and delete markers."""
    N, L = cfg.node_cap, cfg.log_cap
    T = N + L
    B = phys.shape[0]
    rv = snap.read_version
    nv = snap.version[phys]                    # [B]
    rank, used = leaf_ranks(snap.nitems[phys], snap.nlog[phys],
                            snap.log_backptr[phys], snap.log_hint[phys], N, L)
    svis, lvis_slot = used[:, :N], used[:, N:]
    lver = nv[:, None] + snap.log_vdelta[phys]
    lvis = lvis_slot & (lver <= rv)

    keys = torch.cat([snap.skeys[phys], snap.log_keys[phys]], dim=1)
    klens = torch.cat([snap.skeylen[phys], snap.log_keylen[phys]], dim=1)
    vals = torch.cat([snap.svals[phys], snap.log_vals[phys]], dim=1)
    vlens = torch.cat([snap.svallen[phys], snap.log_vallen[phys]], dim=1)
    vers = torch.cat([nv[:, None].expand(B, N), lver], dim=1)
    isdel = torch.cat([torch.zeros_like(svis),
                       snap.log_op[phys] == LOG_DELETE], dim=1)
    vis = torch.cat([svis, lvis], dim=1)

    # order by rank (stable; ranks of used slots are unique)
    order = torch.argsort(rank, dim=1, stable=True)
    keys, klens, vals, vlens = (_take(keys, order), _take(klens, order),
                                _take(vals, order), _take(vlens, order))
    vers, isdel = _take(vers, order), _take(isdel, order)
    vis, used = _take(vis, order), _take(used, order)

    # --- shadow resolution: equal keys are adjacent; newest visible wins ---
    same_prev = (torch_key_cmp(keys[:, 1:], klens[:, 1:],
                               keys[:, :-1], klens[:, :-1]) == 0) \
        & used[:, 1:] & used[:, :-1]
    run_id = torch.cat([torch.zeros(B, 1, dtype=torch.int64,
                                    device=phys.device),
                        (~same_prev).cumsum(dim=1)], dim=1)
    vmask = torch.where(vis, vers, INT32_MIN)
    # per-run max version via scatter-max into T bins (run_id < T)
    seg_max = torch.full((B, T), INT32_MIN, dtype=torch.int32,
                         device=phys.device)
    seg_max = seg_max.scatter_reduce(1, run_id, vmask, reduce="amax")
    winner = vis & (vmask == torch.gather(seg_max, 1, run_id))
    live = winner & ~isdel
    return keys, klens, vals, vlens, live


def batched_scan(snap, lo: torch.Tensor, lolen: torch.Tensor,
                 hi: torch.Tensor, hilen: torch.Tensor,
                 cfg: HoneycombConfig) -> ScanResult:
    """SCAN(K_l, K_u) for a batch: floor-start semantics, forward across
    sibling leaves with bounded budget (Section 3.3)."""
    snap = snapshot_fields(snap, cfg)
    leaf0 = descend(snap, lo, lolen, cfg)
    return scan_from_leaf(snap, leaf0, lo, lolen, hi, hilen, cfg)


def scan_from_leaf(snap: SnapshotFields, leaf0: torch.Tensor,
                   lo: torch.Tensor, lolen: torch.Tensor,
                   hi: torch.Tensor, hilen: torch.Tensor,
                   cfg: HoneycombConfig,
                   trace: RowTrace | None = None) -> ScanResult:
    """The scan engine proper, starting from pre-descended leaf rows —
    shared between the reference path (heap view) and the fused oracle
    (combined cache+heap view), so the two paths cannot drift.
    ``trace``, when given, records the sibling leaves each lane moves to."""
    c = cfg
    B = lo.shape[0]
    M = c.max_scan_items
    KW, VW = c.key_words, c.val_words
    T = c.node_cap + c.log_cap
    rv = snap.read_version
    i32 = dict(dtype=torch.int32, device=lo.device)
    rows = torch.arange(B, device=lo.device)
    arT = _arange(T, lo)[None, :]

    # ---- floor pre-pass: walk left until some visible key <= lo ----------
    phys = leaf0
    fkeys = torch.zeros(B, KW, **i32)
    fklens = torch.zeros(B, **i32)
    fvals = torch.zeros(B, VW, **i32)
    fvlens = torch.zeros(B, **i32)
    have = torch.zeros(B, dtype=torch.bool, device=lo.device)
    for _ in range(c.max_scan_leaves):
        keys, klens, vals, vlens, live = _resolve_leaf(snap, phys, c)
        leq = live & (torch_key_cmp(keys, klens, lo[:, None, :],
                                    lolen[:, None]) <= 0)
        idx = torch.where(leq, arT, -1).amax(dim=1)
        found = idx >= 0
        sel = idx.clamp(min=0)
        upd = found & ~have
        fkeys = torch.where(upd[:, None], keys[rows, sel], fkeys)
        fklens = torch.where(upd, klens[rows, sel], fklens)
        fvals = torch.where(upd[:, None], vals[rows, sel], fvals)
        fvlens = torch.where(upd, vlens[rows, sel], fvlens)
        have = have | found
        nxt = snap.lsib[phys]
        can_move = ~have & (nxt != NULL)
        nxt_phys = _resolve_version(snap, snap.pagetable[nxt.clamp(min=0)],
                                    rv, c, trace, can_move)
        if trace is not None:
            trace.count(can_move)
        phys = torch.where(can_move, nxt_phys, phys)

    # one spare result slot (index M) absorbs the writes of lanes that do
    # not emit, so emitted slots are written exactly once
    out_keys = torch.zeros(B, M + 1, KW, **i32)
    out_klens = torch.zeros(B, M + 1, **i32)
    out_vals = torch.zeros(B, M + 1, VW, **i32)
    out_vlens = torch.zeros(B, M + 1, **i32)
    emit_floor = have & (torch_key_cmp(fkeys, fklens, hi, hilen) <= 0)
    out_keys[:, 0] = torch.where(emit_floor[:, None], fkeys, 0)
    out_klens[:, 0] = torch.where(emit_floor, fklens, 0)
    out_vals[:, 0] = torch.where(emit_floor[:, None], fvals, 0)
    out_vlens[:, 0] = torch.where(emit_floor, fvlens, 0)
    count = emit_floor.to(torch.int32)
    trunc = torch.zeros(B, dtype=torch.bool, device=lo.device)

    # ---- forward scan across sibling leaves ------------------------------
    phys = leaf0
    done = torch.zeros(B, dtype=torch.bool, device=lo.device)
    for _ in range(c.max_scan_leaves):
        keys, klens, vals, vlens, live = _resolve_leaf(snap, phys, c)
        gt_lo = torch_key_cmp(keys, klens, lo[:, None, :],
                              lolen[:, None]) > 0
        leq_hi = torch_key_cmp(keys, klens, hi[:, None, :],
                               hilen[:, None]) <= 0
        emit = live & gt_lo & leq_hi & ~done[:, None]
        slot = count[:, None] + emit.cumsum(dim=1) - 1
        ok = emit & (slot < M)
        slot_c = torch.where(ok, slot.clamp(0, M - 1), M)
        br = rows[:, None]
        out_keys[br, slot_c] = keys
        out_klens[br, slot_c] = klens
        out_vals[br, slot_c] = vals
        out_vlens[br, slot_c] = vlens
        count = count + ok.sum(dim=1, dtype=torch.int32)
        trunc = trunc | (emit & ~ok).any(dim=1)
        # a request is done when this leaf held a live key beyond hi or
        # there is no right sibling
        past_hi = (live & ~leq_hi).any(dim=1)
        nxt = snap.rsib[phys]
        done = done | past_hi | (nxt == NULL) | trunc
        nxt_phys = _resolve_version(snap, snap.pagetable[nxt.clamp(min=0)],
                                    rv, c, trace, ~done)
        if trace is not None:
            trace.count(~done)
        phys = torch.where(done, phys, nxt_phys)
    trunc = trunc | ~done
    return ScanResult(count, out_keys[:, :M].contiguous(),
                      out_klens[:, :M].contiguous(),
                      out_vals[:, :M].contiguous(),
                      out_vlens[:, :M].contiguous(), trunc)


def batched_get(snap, key: torch.Tensor, klen: torch.Tensor,
                cfg: HoneycombConfig) -> GetResult:
    """GET(K) implemented as SCAN(K, K) + post-processing (Section 3.3)."""
    res = batched_scan(snap, key, klen, key, klen, cfg)
    return get_from_scan(res, key, klen)


def get_from_scan(res: ScanResult, key: torch.Tensor,
                  klen: torch.Tensor) -> GetResult:
    """The GET equality post-pass over a SCAN(K, K) result.  On a miss it
    returns slot 0's value, exactly like the reference."""
    M = res.keys.shape[1]
    eq = (torch_key_cmp(res.keys, res.keylens, key[:, None, :],
                        klen[:, None]) == 0) \
        & (_arange(M, key)[None, :] < res.count[:, None])
    found = eq.any(dim=1)
    idx = eq.to(torch.uint8).argmax(dim=1)
    rows = torch.arange(key.shape[0], device=key.device)
    return GetResult(found, res.vals[rows, idx], res.vallens[rows, idx])
