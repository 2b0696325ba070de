"""The live store dry run (port of the live half of
``repro.launch.store_dryrun``): small range-sharded and replicated
Honeycomb stores driven end to end through the deployment shape of the
paper's service.

* ``live_sharded_smoke()`` drives a live ``ShardedHoneycombStore``: a
  uniform range partition, per-shard resident snapshots and delta syncs,
  router-split GET batches, a SCAN stitched across every shard, a write
  burst confined to one shard (one delta sync), and one pipelined service
  epoch of typed op messages through ``HoneycombService`` (core/api.py)
  with independent per-shard flips.  It reports per-shard sync traffic,
  router load imbalance, the read path's cache meters and the registry's
  telemetry.
* ``live_replicated_smoke()`` adds the replication axis: follower
  replicas fed by the log-shipped wire stream, replayed on the device
  (falling back to image-row deltas when the tree shape changed),
  round-robin read spreading, and the lag, amplification and feed meters.

Both hold the fused read path against the per-level reference path on
the same snapshots, by dispatching the same batch through the shard with
``read_backend="reference"``.  (The reference package reads a cache-less
copy of the snapshot for that; the port never reads a packed snapshot
without its cache tier another way, it raises.)  The reference module's
XLA compile analysis of a mesh-scale deployment has no counterpart here.

Run on the card, writing the results and the telemetry under
``experiments/``:

    PYTHONPATH=src python -m repro_torch.launch.store_dryrun [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..core import (Get, HoneycombConfig, HoneycombService,
                    ReplicationConfig, ShardedHoneycombStore,
                    TelemetryConfig, Update, uniform_int_boundaries)
from ..core.keys import int_key


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
        snap = sh._snapshot_for_read()
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--out", default="experiments",
                    help="directory of the JSON results")
    args = ap.parse_args(argv)
    out = {
        "live_sharded_store": live_sharded_smoke(device=args.device),
        "live_replicated_store": live_replicated_smoke(device=args.device),
    }
    # the observability artifacts land next to the results: one registry
    # snapshot per live smoke, and the replicated smoke's sampled
    # lifecycle traces as a Perfetto-loadable Chrome trace-event file.  The
    # bulky exports are popped out of the results JSON.
    exp = Path(args.out)
    exp.mkdir(parents=True, exist_ok=True)
    metrics = {k: v["telemetry"]["snapshot"] for k, v in out.items()}
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
