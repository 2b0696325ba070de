"""Dispatch for the port's kernels (port of ``repro.kernels.ops``).

The tensor's device selects the implementation: a CPU tensor runs the
plain PyTorch version (``kernels/ref.py``), a CUDA tensor launches the
hand-written kernel (``key_search.py``: the KSU floor search, plain and
over packed node images; ``leaf_merge.py``: the RSU merge;
``delta_scatter.py``: row scatter, multi-field scatter and log replay;
``fused_read.py``; ``paged_attention.py``: decode attention over paged
KV; ``moe_grouped.py``: prefill's grouped expert FFN), and any other
device raises.  A CUDA call never falls
back to the plain version.

``READ_DISPATCHES`` meters dispatched launches per read batch, recorded
at the shard's dispatch site: the fused kernel executes the whole
traversal in ONE launch, where the reference path issues one stage per
descend level plus one per scan-leaf visit (floor pre-pass + forward
pass) and GET adds its equality post-pass.  ``kernels/build.LAUNCHES``
counts the launches each kernel wrapper actually made.
"""
from __future__ import annotations

import collections

import torch

from . import delta_scatter as _ds
from . import fused_read as _fr
from . import key_search as _ks
from . import leaf_merge as _lm
from . import moe_grouped as _mg
from . import paged_attention as _pa
from . import ref as _ref

READ_DISPATCHES: collections.Counter = collections.Counter()


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def _fused_device(snap) -> bool:
    """The fused read serves only a snapshot with its cache tier attached
    (every publish attaches it); True when the snapshot lies on CUDA."""
    if snap.cache_lids is None or snap.cache_image is None:
        raise ValueError("the fused read needs the snapshot's cache tier")
    return _on_cuda(snap.image)


def read_dispatch_count(op: str, read_backend: str, cfg) -> int:
    """Device dispatches one ``op`` ("get"/"scan") batch costs under
    ``read_backend`` ("fused"/"reference") at this config's static
    traversal bounds."""
    if read_backend == "fused":
        return 1
    n = cfg.max_height + 2 * cfg.max_scan_leaves
    return n + 1 if op == "get" else n


def record_read_dispatch(op: str, read_backend: str, cfg, batches: int = 1):
    """Meter ``batches`` read-batch dispatches (called per device call by
    the shard layer)."""
    READ_DISPATCHES[(op, read_backend)] += \
        batches * read_dispatch_count(op, read_backend, cfg)
    READ_DISPATCHES[("batches", op, read_backend)] += batches


def reset_read_dispatches():
    READ_DISPATCHES.clear()


def read_dispatch_stats() -> dict:
    """Per-(op, backend) dispatched-launch totals and per-batch averages."""
    out = {}
    for op in ("get", "scan"):
        for rb in ("fused", "reference"):
            b = READ_DISPATCHES.get(("batches", op, rb), 0)
            d = READ_DISPATCHES.get((op, rb), 0)
            if b:
                out[f"{op}_{rb}"] = {"batches": b, "dispatches": d,
                                     "per_batch": d / b}
    return out


def collect() -> list:
    """Telemetry source for the launch meter: plain
    ``(name, kind, value, labels)`` tuples, as in the reference."""
    out = []
    for op in ("get", "scan"):
        for rb in ("fused", "reference"):
            b = READ_DISPATCHES.get(("batches", op, rb), 0)
            d = READ_DISPATCHES.get((op, rb), 0)
            if b or d:
                labels = {"layer": "kernel", "op": op, "backend": rb}
                out.append(("read_dispatches", "counter", d, labels))
                out.append(("read_batches", "counter", b, labels))
    return out


def key_search(q, qlen, keys, klens, valid):
    """KSU floor search: [B] int32, the largest ``i`` with ``valid[b, i]``
    and ``keys[b, i] <= q[b]``, else -1 (q [B, KW], keys [B, N, KW]: int32
    bit views of u32 lanes; qlen [B], klens and valid [B, N] int32)."""
    if _on_cuda(keys):
        return _ks.key_search(q, qlen, keys, klens, valid)
    return _ref.key_search_ref(q, qlen, keys, klens, valid)


def key_search_image(q, qlen, node_img, *, keys_off, lens_off, count_off,
                     n_keys, key_words):
    """Floor search addressed INSIDE packed node images: the candidate
    block of request ``b`` is read from ``node_img[b]`` at the static
    layout offsets (core/schema.py) instead of arriving as separate
    key/length/valid operands."""
    kw = dict(keys_off=keys_off, lens_off=lens_off, count_off=count_off,
              n_keys=n_keys, key_words=key_words)
    if _on_cuda(node_img):
        return _ks.key_search_image(q, qlen, node_img, **kw)
    return _ref.key_search_image_ref(q, qlen, node_img, **kw)


def leaf_merge(nitems, nlog, backptr, hints, *, node_cap, log_cap):
    """RSU merged-emission permutation of a batch of leaves: (perm,
    valid), each [B, node_cap + log_cap] int32."""
    if _on_cuda(nitems):
        return _lm.leaf_merge(nitems, nlog, backptr, hints,
                              node_cap=node_cap, log_cap=log_cap)
    return _ref.leaf_merge_ref(nitems, nlog, backptr, hints,
                               node_cap=node_cap, log_cap=log_cap)


def snapshot_delta_scatter(dst, rows, upd):
    """Apply one delta sync's dirty rows to a resident device array, in
    place: dst[rows[i]] = upd[i].  Returns ``dst``."""
    if _on_cuda(dst):
        return _ds.snapshot_delta_scatter(dst, rows, upd)
    return _ref.snapshot_delta_scatter_ref(dst, rows, upd)


def snapshot_image_scatter(image, rows, upd):
    """Apply one delta sync to the PACKED snapshot image, in place: one
    contiguous [image_words] row copy per dirty node.  Returns
    ``image``."""
    if _on_cuda(image):
        return _ds.snapshot_image_scatter(image, rows, upd)
    return _ref.snapshot_image_scatter_ref(image, rows, upd)


def snapshot_multi_scatter(dsts, rows, upd):
    """Apply one delta sync to EVERY per-field tensor of a legacy-layout
    snapshot, in place, in one call: dsts[f][rows[i]] = upd[f][i] with
    ``dsts``/``upd`` matching sequences of [S, W_f]/[D, W_f] tensors.
    Returns ``dsts`` as a tuple."""
    dsts = tuple(dsts)
    if _on_cuda(dsts[0]):
        return _ds.snapshot_multi_scatter(dsts, rows, upd)
    return _ref.snapshot_multi_scatter_ref(dsts, rows, upd)


def log_replay_scatter(image, rows, slots, entries, *, offs):
    """Replay marshalled log entries into a resident packed image, in
    place (the log-shipped replication feed): entry ``i`` writes its
    ~(key_words + val_words + 6) words into row ``rows[i]`` at log slot
    ``slots[i]`` (static offsets ``offs``, ``core/schema.LogReplayOffsets``)
    and each touched row's ``nlog`` becomes its highest slot + 1.  Returns
    ``image``."""
    if _on_cuda(image):
        return _ds.log_replay_scatter(image, rows, slots, entries, offs=offs)
    return _ref.log_replay_scatter_ref(image, rows, slots, entries,
                                       offs=offs)


def batched_get_fused(snap, key, klen, *, cfg, lb_fraction: float = 0.0):
    """Fused device-resident GET: the whole batch traversal in ONE launch,
    the first ``cfg.cache_levels`` levels served from the snapshot's cache
    tier.  Returns (GetResult, meters i32[3] =
    [vmem_hits, heap_gathers, lb_routed])."""
    if _fused_device(snap):
        return _fr.batched_get_fused(snap, key, klen, cfg=cfg,
                                     lb_fraction=lb_fraction)
    return _ref.batched_get_fused_ref(snap, key, klen, cfg=cfg,
                                      lb_fraction=lb_fraction)


def batched_scan_fused(snap, lo, lolen, hi, hilen, *, cfg,
                       lb_fraction: float = 0.0):
    """Fused device-resident SCAN — see ``batched_get_fused``.  Returns
    (ScanResult, meters i32[3])."""
    if _fused_device(snap):
        return _fr.batched_scan_fused(snap, lo, lolen, hi, hilen, cfg=cfg,
                                      lb_fraction=lb_fraction)
    return _ref.batched_scan_fused_ref(snap, lo, lolen, hi, hilen, cfg=cfg,
                                       lb_fraction=lb_fraction)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    start_pos=None, *, scale: float | None = None,
                    softcap: float = 0.0):
    """Decode attention over paged KV: q [B, H, D] against the positions
    ``start_pos[b] <= pos < seq_lens[b]`` of the pages ``block_tables[b]``
    names in k_pages/v_pages [NP, P, KVH, D].  Returns [B, H, D] of q's
    type; an empty window gives zeros."""
    kw = dict(scale=scale, softcap=softcap)
    if _on_cuda(q):
        return _pa.paged_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens, start_pos, **kw)
    return _ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                    seq_lens, start_pos, **kw)


def moe_grouped(x2d, gates, ids, w_gate, w_up, w_down):
    """The grouped expert FFN: token t of x2d [T, d] through its experts
    ids[t] ([T, k] int64) only, weighted by gates[t] ([T, k] f32) and
    summed in f32 in slot order; weights [E, d, f], [E, d, f], [E, f,
    d].  Returns [T, d] of x2d's type."""
    if _on_cuda(x2d):
        return _mg.moe_grouped(x2d, gates, ids, w_gate, w_up, w_down)
    return _mg.moe_grouped_plain(x2d, gates, ids, w_gate, w_up, w_down)
