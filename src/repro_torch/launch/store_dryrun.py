"""The store dry run (port of ``repro.launch.store_dryrun``): the paper's
own workload at production scale, a range-sharded Honeycomb service with
one shard's tree on each of 256 devices, each serving its slice of the
request batch (the router pre-partitions by range, so the read path is
collective-free).

Two halves, as in the reference:

* the **mesh-scale half** sizes ONE shard with the per-shard item count
  the router's uniform boundaries give (128M / 256 = 500,000 items):
  ``abstract_snapshot``/``abstract_delta`` give the snapshot's and a
  delta's ``Spec`` records (the image as the port's int32 bit view, the
  same bytes as the reference's u32; the two sync scalars, plain ints on
  the port's snapshot, counted as the reference's 4-byte int32 scalars),
  and ``delta_sync_analysis`` their bytes: what a delta moves against a
  wholesale republish.  The reference's ``compiled_temp_gb`` (XLA's
  scratch for the delta apply, which updates in place) has no twin; on
  the card ``main`` reports instead the allocator's peak rise over one
  ``apply_snapshot_delta``, which clones the whole image.  The two
  pipeline stages (``core/pipeline.py``: the standby delta scatter and
  the batched GET) are not modelled from a roofline as in the reference:
  ``pipeline_stages`` builds a live shard of that size on the card and
  TIMES one ``apply_snapshot_delta`` and one fused GET batch of 512
  (profiler device time, the L2 flushed before each call), and
  ``pipeline_occupancy_model`` keeps the reference's arithmetic over the
  two times (serial epoch = export + read, pipelined = max).  On the CPU
  nothing is timed.  The service's own figures (``service_figures``):
  the bytes one device holds for a GET + SCAN batch (arguments and
  outputs from the specs, the temporaries as the allocator's measured
  peak rise), the collectives one shard's read issues (counted by
  ``launch/hlo_analysis``: none), and the reads per second the fused
  GET's byte count allows at the H100's data-sheet memory rate (a bound,
  not a measurement);
* the **live half** drives small stores end to end:
  ``live_sharded_smoke()`` a live ``ShardedHoneycombStore``: a
  uniform range partition, per-shard resident snapshots and delta syncs,
  router-split GET batches, a SCAN stitched across every shard, a write
  burst confined to one shard (one delta sync), and one pipelined service
  epoch of typed op messages through ``HoneycombService`` (core/api.py)
  with independent per-shard flips.  It reports per-shard sync traffic,
  router load imbalance, the read path's cache meters and the registry's
  telemetry.  ``live_replicated_smoke()`` adds the replication axis:
  follower replicas fed by the log-shipped wire stream, replayed on the
  device (falling back to image-row deltas when the tree shape changed),
  round-robin read spreading, and the lag, amplification and feed meters.
  Both hold the fused read path against the per-level reference path on
  the same snapshots, by dispatching the same batch through the shard
  with ``read_backend="reference"``.  (The reference package reads a
  cache-less copy of the snapshot for that; the port never reads a
  packed snapshot without its cache tier another way, it raises.)

Run on the card, writing the results and the telemetry under
``experiments/``:

    PYTHONPATH=src python -m repro_torch.launch.store_dryrun [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from ..core import (Get, HoneycombConfig, HoneycombService, HoneycombStore,
                    ReplicationConfig, ShardedHoneycombStore,
                    TelemetryConfig, Update, uniform_int_boundaries)
from ..core.keys import int_key, pack_keys
from ..core.read_path import SnapshotDelta, TreeSnapshot, apply_snapshot_delta
from ..core.schema import NodeImageLayout
from ..models.schema import Spec
from . import hlo_analysis as hla
from .devtime import device_all_ms

I32 = torch.int32


# ------------------------------------------------------ the mesh-scale half
def abstract_snapshot(cfg: HoneycombConfig, n_items: int, shards: int):
    """``Spec`` records of one shard's snapshot (the paper's store: 128M
    items, 55% leaf occupancy), in the reference's field order, and its
    physical slot count S.  Shard sizing matches the live router's
    uniform range partition (n_items // shards items each); the snapshot
    is the packed node image, [S, image_words] words."""
    items_per_shard = n_items // shards
    leaves = math.ceil(items_per_shard / (cfg.node_cap * 0.55))
    interior = math.ceil(leaves / (cfg.node_cap * 0.55)) + 8
    S = leaves + interior + 64          # physical slots incl. old versions
    iw = NodeImageLayout.for_config(cfg).image_words
    return TreeSnapshot(
        image=Spec((S, iw), I32),
        pagetable=Spec((S,), I32),
        root_lid=Spec((), I32),
        read_version=Spec((), I32),
        cache_lids=Spec((cfg.cache_slots,), I32),
        cache_image=Spec((cfg.cache_slots, iw), I32),
    ), S


def abstract_delta(cfg: HoneycombConfig, snap: TreeSnapshot, dirty_rows: int,
                   pt_commands: int) -> SnapshotDelta:
    """``Spec`` records of one shard's delta sync: D whole node-image rows
    (one contiguous copy per dirty node), P page-table commands and the
    two scalars."""
    return SnapshotDelta(
        rows=Spec((dirty_rows,), I32),
        image=Spec((dirty_rows, snap.image.shape[1]), I32),
        pt_lids=Spec((pt_commands,), I32), pt_phys=Spec((pt_commands,), I32),
        root_lid=Spec((), I32), read_version=Spec((), I32),
        cache_lids=(None if snap.cache_lids is None
                    else Spec(snap.cache_lids.shape, I32)))


def spec_bytes(tree) -> int:
    """The bytes of every ``Spec`` leaf of a (named) tuple."""
    if isinstance(tree, Spec):
        return math.prod(tree.shape) * tree.dtype.itemsize
    if isinstance(tree, tuple):
        return sum(spec_bytes(x) for x in tree)
    return 0


def delta_sync_analysis(cfg: HoneycombConfig, snap_abs: TreeSnapshot,
                        dirty_rows: int = 256,
                        pt_commands: int = 64) -> dict:
    """One shard's host-to-device sync traffic: a delta's argument bytes
    against the wholesale snapshot's.  (The reference also reports
    ``compiled_temp_gb``, XLA's scratch for the apply; see the module
    docstring.)"""
    delta_abs = abstract_delta(cfg, snap_abs, dirty_rows, pt_commands)
    full_bytes = spec_bytes(snap_abs)
    delta_bytes = spec_bytes(delta_abs)
    return {
        "dirty_rows": dirty_rows, "pagetable_commands": pt_commands,
        "delta_bytes_per_sync": delta_bytes,
        "full_snapshot_bytes": full_bytes,
        "traffic_ratio": delta_bytes / full_bytes,
    }


def pipeline_occupancy_model(export_s: float, read_s: float,
                             dirty_rows: int = 256,
                             batch_per_shard: int = 512) -> dict:
    """What double-buffering buys the epoch pipeline (core/pipeline.py),
    from one shard's two stage times: a serial epoch pays export + read
    back to back (the sync barrier); a pipelined epoch pays max(export,
    read) once the pipe fills, because one shard's reads run while
    another's scatter drains.  A stage's occupancy is its share of the
    bottleneck stage."""
    serial_s = export_s + read_s
    pipelined_s = max(export_s, read_s)
    bottleneck = pipelined_s or 1e-30
    return {
        "dirty_rows": dirty_rows, "batch_per_shard": batch_per_shard,
        "export_stage_s": export_s, "read_stage_s": read_s,
        "serial_epoch_s": serial_s, "pipelined_epoch_s": pipelined_s,
        "pipeline_speedup": serial_s / bottleneck,
        "stage_occupancy": {"export": export_s / bottleneck,
                            "read": read_s / bottleneck},
        "bottleneck_stage": "export" if export_s >= read_s else "read",
    }


def live_shard(n_keys: int, device: str = "cuda", seed: int = 0
               ) -> HoneycombStore:
    """A live shard of the paper's geometry (``HoneycombConfig()``) holding
    ``n_keys`` 8-byte keys put in a seeded random order, its snapshot
    published."""
    store = HoneycombStore(HoneycombConfig(), device=device)
    for i in np.random.default_rng(seed).permutation(n_keys):
        store.put(int_key(int(i)), b"v" * 12)
    store.export_snapshot()
    return store


def stage_delta(store: HoneycombStore, dirty_rows: int, seed: int = 0):
    """Random updates and inserts (one in four) until about ``dirty_rows``
    node rows are dirty, then one staged delta sync, flipped.  Returns
    (the snapshot before, the ``SnapshotDelta``, the snapshot after, the
    distinct dirty rows, the distinct page-table commands)."""
    rng = np.random.default_rng(seed + 1)
    t = store.tree
    n = len(t)
    base = store.export_snapshot()
    w = 0
    while len(t.heap.dirty) < dirty_rows - 8:
        i = int(rng.integers(0, n))
        if w % 4:
            store.update(int_key(i), b"u" * 12)
        else:
            store.put(int_key(i) + b"\x01", b"i" * 12)
        w += 1
    d, p = len(t.heap.dirty), len(t.pt.pending)
    store.begin_export()
    delta = store.last_staged.delta
    return base, delta, store.flip(), d, p


def read_batch(store: HoneycombStore, batch: int, n_keys: int,
               seed: int = 0) -> tuple:
    """One GET batch of ``batch`` keys of ``live_shard``'s ``n_keys``: the
    keys, and their lanes and lengths as the device takes them (int32 on
    the store's device)."""
    rng = np.random.default_rng(seed + 2)
    keys = [int_key(int(i)) for i in rng.integers(0, n_keys, batch)]
    lanes, lens = pack_keys(keys, store.cfg.key_words)
    dev = store.export_snapshot().image.device
    return (keys, torch.from_numpy(lanes.view(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev))


def get_bytes(snap: TreeSnapshot, keys, lens, cfg: HoneycombConfig) -> int:
    """The bytes one fused GET batch must move, the kernel's byte bound
    (``kernels/fused_read.bytes_moved``) over the distinct image and cache
    rows the walk reads: the kernel's own ``touched`` marks on the card,
    the plain walk's on the CPU."""
    from ..kernels import fused_read, ref
    touched = torch.zeros(snap.image.shape[0] + snap.cache_image.shape[0],
                          dtype=I32, device=keys.device)
    fn = fused_read.batched_get_fused if keys.is_cuda \
        else ref.batched_get_fused_ref
    fn(snap, keys, lens, cfg=cfg, touched=touched)
    return int(fused_read.bytes_moved(cfg, int(touched.sum()), keys.shape[0]))


def service_figures(store: HoneycombStore, keys, lens) -> dict:
    """The mesh-scale service's figures for one device's shard: one GET
    and one SCAN(K, K) batch (the reference's ``service``) through the
    fused reads on ``store``'s snapshot.  ``peak_gb_per_chip``: the
    shard's snapshot and the batch's keys (arguments) and its count,
    values and found flags (outputs) from their shapes, plus the
    temporaries as the allocator's peak rise over the call (the card
    only; None on the CPU); ``collective_bytes``: what the counter saw
    the call issue; ``reads_per_s_per_chip_bound``: the batch over its
    fused GET's bytes at the data-sheet memory rate."""
    from ..kernels import ops
    cfg, snap = store.cfg, store.export_snapshot()

    def service():
        res, _ = ops.batched_scan_fused(snap, keys, lens, keys, lens,
                                        cfg=cfg)
        get, _ = ops.batched_get_fused(snap, keys, lens, cfg=cfg)
        return res.count, res.vals, get.found

    B = keys.shape[0]
    args = sum(t.numel() * t.element_size() for t in
               (snap.image, snap.pagetable, snap.cache_lids,
                snap.cache_image)) + 8 + 2 * (keys.numel() + lens.numel()) * 4
    outs = B * 4 + B * cfg.max_scan_items * cfg.val_words * 4 + B
    temp = None
    if keys.is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = service()
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - before \
            - sum(t.numel() * t.element_size() for t in out)
        del out
    coll = hla.collective_bytes(service)
    bound_s = get_bytes(snap, keys, lens, cfg) / hla.HBM_BW
    return {
        "peak_gb_per_chip": (None if temp is None
                             else (args + outs + temp) / 2 ** 30),
        "argument_bytes": args, "output_bytes": outs, "temp_bytes": temp,
        "collective_bytes": coll["total_bytes"],
        "reads_per_s_per_chip_bound": B / bound_s,
    }


def apply_peak_rise(base: TreeSnapshot, delta: SnapshotDelta,
                    cfg: HoneycombConfig) -> int:
    """The allocator's peak rise over one ``apply_snapshot_delta`` on the
    card (its whole-image clone included); the result is kept until the
    peak is read."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    nxt = apply_snapshot_delta(base, delta, cfg=cfg)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    del nxt
    return rise


def pipeline_stages(store: HoneycombStore, base: TreeSnapshot,
                    delta: SnapshotDelta, keys, lens, reps: int = 16
                    ) -> dict:
    """The epoch pipeline's two stages timed on the card for one shard:
    the export stage, one ``apply_snapshot_delta(base, delta)`` (the
    whole-image clone, the page-table commands, the row-scatter kernel
    and the cache tier's rebuild), and the read stage, one fused GET
    batch of ``keys`` on the store's snapshot; each the device time of
    every activity of one call, L2 flushed (``devtime.device_all_ms``)."""
    from ..kernels import ops
    if not keys.is_cuda:
        raise RuntimeError("the pipeline's stages are timed on the card; "
                           "on the CPU nothing is timed")
    cfg, snap = store.cfg, store.export_snapshot()
    flush = torch.empty(128 << 20, dtype=torch.int8, device=keys.device)
    export_ms, export_by = device_all_ms(
        [lambda: apply_snapshot_delta(base, delta, cfg=cfg)], reps, flush,
        {"row_scatter_kernel": 1, "Memcpy DtoD": 1})
    read_ms, read_by = device_all_ms(
        [lambda: ops.batched_get_fused(snap, keys, lens, cfg=cfg)], reps,
        flush, {"fused_read_kernel": 1})
    del flush
    return {"export_ms": export_ms, "read_ms": read_ms,
            "export_activities": export_by, "read_activities": read_by}


def _telemetry_report(svc: HoneycombService) -> dict:
    """The smoke's observability artifact (core/telemetry.py): the full
    registry snapshot, the Prometheus exposition, the Chrome trace-event
    JSON (written next to the results by ``main``, Perfetto-loadable), and
    the last sampled trace's span chain and stamps."""
    traces = svc.traces()
    last = traces[-1] if traces else None
    return {
        "snapshot": svc.metrics_snapshot(),
        "prometheus": svc.prometheus(),
        "chrome_trace": svc.chrome_trace(),
        "sampled_traces": len(traces),
        "last_trace": ({"kind": last.kind, "spans": last.span_names(),
                        "tags": last.tags} if last else None),
    }


def live_sharded_smoke(shards: int = 4, n_items: int = 1024,
                       batch: int = 64, device: str = "cuda") -> dict:
    """Drive a small live ``ShardedHoneycombStore`` through the
    deployment shape: uniform range partition, per-shard resident
    snapshots and delta syncs, router-split GET batches, cross-shard SCAN
    stitching, then one pipelined service epoch.  Returns the per-shard
    sync traffic, load imbalance, cache meters and telemetry."""
    cfg = HoneycombConfig()
    st = ShardedHoneycombStore(
        cfg, heap_capacity=1024, shards=shards,
        boundaries=uniform_int_boundaries(n_items, shards), device=device)
    rng = np.random.default_rng(11)
    for i in rng.permutation(n_items):
        st.put(int_key(int(i)), b"v" * 12)
    st.export_snapshot()                     # resident snapshot per shard
    # router-split GET batch + one scan spanning every shard
    keys = [int_key(int(k)) for k in rng.integers(0, n_items, batch)]
    st.get_batch(keys)
    span = st.scan_batch([(int_key(1), int_key(n_items - 2))])[0]
    # write burst confined to one shard -> exactly one delta sync
    snaps0 = [s.snapshots for s in st.per_shard_sync_stats]
    lo_shard = n_items // shards
    for k in range(batch):
        st.update(int_key(k % lo_shard), b"u" * 12)
    st.export_snapshot()
    dirty = [s.snapshots - b for s, b in zip(st.per_shard_sync_stats, snaps0)]
    # one pipelined service epoch (typed op messages, routing self-wired
    # from the store): staged standby scatters + independent per-shard
    # flips + immediate read dispatch
    svc = HoneycombService(
        st, batch_size=batch, pipeline="pipelined",
        telemetry=TelemetryConfig(trace_sample_rate=0.25))
    svc.submit_many(
        op for k in range(batch)
        for op in (Update(int_key(int(rng.integers(0, n_items))), b"p" * 12),
                   Get(int_key(int(rng.integers(0, n_items))))))
    svc.drain()
    # the default backend served through the fused kernel with the cache
    # tier resolving levels, and answers as the per-level reference path
    # does on the same snapshot, through the same shard's dispatch
    span_per_shard = n_items // shards
    for i, sh in enumerate(st.shards):
        pk = [int_key(int(k)) for k in
              rng.integers(i * span_per_shard, (i + 1) * span_per_shard, 16)]
        snap = sh.snapshot_for_read()
        assert sh._device_get(snap, pk) == \
            sh._device_get(snap, pk, read_backend="reference"), \
            f"fused GET diverged from reference on shard {i}"
        pr = [(pk[0], pk[1])]
        assert sh._device_scan(snap, pr, None) == \
            sh._device_scan(snap, pr, None, read_backend="reference"), \
            f"fused SCAN diverged from reference on shard {i}"
    vmem_hits = sum(sh.cache.stats.vmem_hits for sh in st.shards)
    heap_gathers = sum(sh.cache.stats.heap_gathers for sh in st.shards)
    assert vmem_hits > 0, "cache tier never served a descend level"
    agg = st.sync_stats
    ps = st.pipeline_stats
    return {
        "shards": shards, "items": n_items, "layout": cfg.layout,
        "cross_shard_scan_items": len(span),
        "image_dma_count": agg.image_dma_count,
        "image_bytes": agg.image_bytes,
        "per_shard_bytes_synced": [s.bytes_synced
                                   for s in st.per_shard_sync_stats],
        "per_shard_delta_syncs": [s.delta_syncs
                                  for s in st.per_shard_sync_stats],
        "dirty_shard_syncs_after_confined_burst": dirty,
        "log_wire_bytes": agg.log_wire_bytes,
        "load_imbalance": st.load_imbalance,
        "read_path": {
            "backend": cfg.read_backend,
            "vmem_hits": vmem_hits,
            "heap_gathers": heap_gathers,
            "fused_matches_reference": True,     # asserted above
        },
        "pipelined_epoch": {
            "per_shard_epochs": st.per_shard_epochs,
            "staged_exports": ps.staged_exports, "flips": ps.flips,
            "sync_stall_s": svc.stats.sync_stall_s,
            "lane_occupancy": svc.stats.lane_occupancy,
        },
        "telemetry": _telemetry_report(svc),
    }


def live_replicated_smoke(shards: int = 2, replicas: int = 2,
                          n_items: int = 512, batch: int = 64,
                          device: str = "cuda") -> dict:
    """The replication twin of ``live_sharded_smoke``: each shard serves
    from a primary plus follower replicas fed by the primary's log-shipped
    op wire stream, replayed on the device by the log-replay kernel
    (tree-shape-changing epochs fall back to the image delta), with
    round-robin read spreading.  Reports per-replica served lanes, the
    feed's bytes (primary egress and relay hops, fallback epochs) and the
    epoch-lag freshness meters."""
    cfg = HoneycombConfig()
    st = ShardedHoneycombStore(
        cfg, heap_capacity=1024, shards=shards,
        boundaries=uniform_int_boundaries(n_items, shards),
        replication=ReplicationConfig(replicas=replicas,
                                      policy="round_robin"),
        device=device)
    rng = np.random.default_rng(13)
    for i in rng.permutation(n_items):
        st.put(int_key(int(i)), b"v" * 12)
    st.export_snapshot()                 # primaries + followers resident
    svc = HoneycombService(
        st, batch_size=batch // 2, pipeline="pipelined",
        telemetry=TelemetryConfig(trace_sample_rate=0.25))
    tickets = svc.submit_many(
        op for k in range(batch)
        for op in (Update(int_key(int(rng.integers(0, n_items))), b"r" * 12),
                   Get(int_key(int(rng.integers(0, n_items)))),
                   Get(int_key(int(rng.integers(0, n_items))))))
    svc.drain()
    reads = [t.result() for t in tickets if not t.op.IS_WRITE]
    # settle bursts: an epoch whose updates overflow a leaf log merges the
    # leaf (a page-table command -> metered fallback to the image delta);
    # the next burst appends into the freshly merged leaves, so within a
    # few rounds an epoch must ship over the log feed
    burst = [int_key(0), int_key(n_items - 1)]      # one leaf per shard
    for _ in range(4):
        if st.feed_stats.log_feed_epochs > 0:
            break
        for k in burst * 3:
            st.update(k, b"l" * 12)
        st.export_snapshot()
    fs = st.feed_stats
    assert fs.log_feed_epochs > 0, "log feed never engaged"
    assert fs.log_bytes > 0 and fs.wire_bytes > 0
    log_replays = sum(f.sync_stats.log_replays
                      for sh in st.shards for f in sh.followers)
    assert log_replays > 0, "no follower replayed a log payload on device"
    # followers inherit the cache tier through the feeds, and their fused
    # reads answer as the per-level reference path on the same image
    vmem_hits = 0
    for sh in st.shards:
        for f in sh.followers:
            snap = f.snapshot
            assert snap is not None and snap.cache_image is not None, \
                "follower lost the cache tier over the feed"
            pk = [int_key(int(k)) for k in rng.integers(0, n_items, 8)]
            got = sh.primary._device_get(snap, pk)
            ref = sh.primary._device_get(snap, pk, read_backend="reference")
            assert got == ref, "follower fused GET diverged from reference"
        vmem_hits += sh.cache.stats.vmem_hits
    assert vmem_hits > 0, "cache tier never served a descend level"
    return {
        "shards": shards, "replicas": replicas, "items": n_items,
        "layout": cfg.layout,
        "primary_image_dmas": st.sync_stats.image_dma_count,
        "served_replica_lanes": sorted({r.replica for r in reads}),
        "serving_versions": sorted({r.serving_version for r in reads}),
        "per_shard_replica_ops": st.per_shard_replica_ops,
        "replica_load_imbalance": st.replica_load_imbalance,
        "replication_bytes": st.replication_bytes,
        "feed": {
            "feed_bytes": fs.feed_bytes,
            "log_feed_epochs": fs.log_feed_epochs,
            "log_fallback_epochs": fs.log_fallback_epochs,
            "log_bytes": fs.log_bytes,
            "wire_bytes": fs.wire_bytes,
            "fallback_bytes": fs.fallback_bytes,
            "primary_egress_bytes": fs.primary_egress_bytes,
            "relay_hop_bytes": fs.relay_hop_bytes,
            "log_replays": log_replays,
        },
        "primary_sync_bytes": st.sync_stats.bytes_synced,
        "read_path": {
            "backend": cfg.read_backend,
            "vmem_hits": vmem_hits,
            "followers_cache_resident": True,    # asserted above
            "fused_matches_reference": True,     # asserted above
        },
        "replica_lag_epochs": st.replica_lag_epochs,
        "replica_staleness": st.replica_staleness,
        "lagging_skips": st.lagging_skips,
        "telemetry": _telemetry_report(svc),
    }


def tree_bytes(tree) -> int:
    """The bytes of a snapshot's or a delta's tensors, its two int
    scalars counted as 4-byte int32 (the reference's)."""
    return sum(x.numel() * x.element_size() if torch.is_tensor(x) else 4
               for x in tree if x is not None)


def mesh_scale(device: str = "cuda", shard_keys: int | None = None,
               batch_per_shard: int = 512, n_items: int = 128_000_000,
               shards: int = 256, seed: int = 0) -> dict:
    """The mesh-scale half (see the module docstring): the abstract
    shard's sizes and delta bytes, a live shard of ``shard_keys`` keys
    (default ``n_items // shards``) with one delta of about 256 dirty
    rows, the service's figures on it, and on the card the pipeline's two
    stages timed (None on the CPU: nothing is timed there)."""
    cfg = HoneycombConfig()
    snap_abs, S = abstract_snapshot(cfg, n_items, shards)
    shard_keys = shard_keys or n_items // shards
    store = live_shard(shard_keys, device, seed)
    base, delta, _, d, p = stage_delta(store, 256, seed)
    _, keys, lens = read_batch(store, batch_per_shard, shard_keys, seed)
    sync = delta_sync_analysis(cfg, snap_abs)
    sync["live_delta"] = {
        "rows": delta.rows.shape[0], "distinct_rows": d,
        "pagetable_commands": delta.pt_lids.shape[0],
        "distinct_pagetable_commands": p, "bytes": tree_bytes(delta)}
    pipeline = None
    if device != "cpu":
        sync["apply_peak_rise_bytes"] = apply_peak_rise(base, delta, cfg)
        st = pipeline_stages(store, base, delta, keys, lens)
        pipeline = {**pipeline_occupancy_model(
            st["export_ms"] / 1e3, st["read_ms"] / 1e3, d, batch_per_shard),
            "card": torch.cuda.get_device_name(keys.device)}
    snap = store.export_snapshot()
    return {
        "workload": f"honeycomb GET+SCAN, {n_items / 1e6:.0f}M items "
                    f"range-sharded over {shards} chips, "
                    f"{batch_per_shard} requests/chip",
        "slots_per_shard": S,
        "live_shard": {"keys": shard_keys,
                       "image_rows": snap.image.shape[0],
                       "live_slots": store.tree.heap.live_slots,
                       "snapshot_bytes": tree_bytes(snap)},
        **service_figures(store, keys, lens),
        "delta_sync": sync,
        "pipeline": pipeline,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--out", default="experiments",
                    help="directory of the JSON results")
    args = ap.parse_args(argv)
    out = {
        **mesh_scale(device=args.device),
        "live_sharded_store": live_sharded_smoke(device=args.device),
        "live_replicated_store": live_replicated_smoke(device=args.device),
    }
    # the observability artifacts land next to the results: one registry
    # snapshot per live smoke, and the replicated smoke's sampled
    # lifecycle traces as a Perfetto-loadable Chrome trace-event file.  The
    # bulky exports are popped out of the results JSON.
    exp = Path(args.out)
    exp.mkdir(parents=True, exist_ok=True)
    metrics = {k: out[k]["telemetry"]["snapshot"]
               for k in ("live_sharded_store", "live_replicated_store")}
    (exp / "torch_store_dryrun_metrics.json").write_text(
        json.dumps(metrics, indent=1))
    trace = out["live_replicated_store"]["telemetry"].pop("chrome_trace")
    out["live_sharded_store"]["telemetry"].pop("chrome_trace")
    (exp / "torch_store_dryrun_trace.json").write_text(json.dumps(trace))
    print(json.dumps(out, indent=1))
    (exp / "torch_store_dryrun.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
