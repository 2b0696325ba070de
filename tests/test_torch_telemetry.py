"""The port's telemetry against the reference (core/telemetry.py, pure
Python on both sides): histogram geometry, percentiles, weighted records
and merges on the same samples; and, on a replicated, sharded, pipelined
store driven through ``HoneycombService`` by both packages with their
clocks frozen, the registry snapshot, the Prometheus text line for line,
the tracer's sampled rids and span names, and the Chrome trace events.
Mirrors tests/test_telemetry.py."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.kernels import ops as jops
from repro_torch.core import (CLOCK, Histogram, HoneycombConfig,
                              HoneycombService, Put, ShardedHoneycombStore,
                              SyncStats, TelemetryConfig, Tracer,
                              merge_stats, parse_prometheus, prom_value,
                              uniform_int_boundaries)
from repro_torch.core import replica as treplica
from repro_torch.core import scheduler as tscheduler
from repro_torch.core import shard as tshard
from repro_torch.core.keys import int_key
from repro_torch.kernels import ops as tops
from test_torch_service import KEYSPACE, SMALL, as_reference, random_ops


@pytest.fixture(scope="module")
def services():
    """The same store, traffic and telemetry settings in both packages,
    every clock frozen: two drained epochs after a load, a quarter of the
    requests traced."""
    tcfg = dict(trace_sample_rate=0.25, trace_capacity=4096)
    out = []
    # the read-dispatch meter is process-wide in both packages: start both
    # from zero so that only this traffic is counted
    jops.reset_read_dispatches()
    tops.reset_read_dispatches()
    with J.CLOCK.frozen(), T.CLOCK.frozen():
        for P, kw in ((J, {}), (T, dict(device="cpu"))):
            st = P.ShardedHoneycombStore(
                P.HoneycombConfig(**SMALL), heap_capacity=256, shards=2,
                boundaries=uniform_int_boundaries(KEYSPACE, 2),
                replication=P.ReplicationConfig(2, "round_robin"), **kw)
            svc = P.HoneycombService(
                st, batch_size=8, pipeline="pipelined",
                telemetry=P.TelemetryConfig(**tcfg))
            rng = np.random.default_rng(4)
            conv = as_reference if P is J else (lambda op: op)
            svc.submit_many(conv(Put(int_key(int(i)), b"v%03d" % i))
                            for i in rng.permutation(KEYSPACE)[:120])
            svc.drain()
            tickets = []
            for _ in range(2):
                tickets += svc.submit_many(conv(op)
                                           for op in random_ops(rng, 60))
                svc.drain()
            out.append((st, svc, tickets))
    return out


# ----------------------------------------------------------------- histogram
def _samples(dist):
    rng = np.random.default_rng(11)
    return {
        "lognormal": np.exp(rng.normal(-8.0, 1.5, 4000)),
        "uniform": rng.uniform(1e-5, 1e-2, 4000),
        "heavy_tail": np.concatenate([rng.uniform(1e-6, 1e-5, 3900),
                                      rng.uniform(0.1, 10.0, 100)]),
        "two_point": np.array([1e-4] * 900 + [1e-1] * 100),
        "out_of_range": np.concatenate([np.full(10, 1e-9),
                                        rng.uniform(1e-4, 1.0, 100),
                                        np.full(3, 5e3)]),
    }[dist]


def _hist_state(h):
    return (h.counts, h.count, h.total, h.vmin, h.vmax, h.to_dict(),
            [h.percentile(p) for p in (0, 1, 50, 95, 99, 99.9, 100)])


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "heavy_tail",
                                  "two_point", "out_of_range"])
@pytest.mark.parametrize("geometry", [{}, dict(lo=1e-3, hi=1e0,
                                               buckets_per_decade=4)])
def test_histogram_matches_reference(dist, geometry):
    """Bucket counts, sums, extremes and every percentile equal the
    reference's on the same samples, also for weighted records."""
    data = _samples(dist)
    hj, ht = J.Histogram(**geometry), Histogram(**geometry)
    for v in data:
        hj.record(float(v))
        ht.record(float(v))
    hj.record(2.5e-3, n=7)
    ht.record(2.5e-3, n=7)
    hj.record(1.0, n=0)
    ht.record(1.0, n=0)
    assert _hist_state(ht) == _hist_state(hj)
    assert ht.count == len(data) + 7


def test_histogram_merge_matches_reference():
    rng = np.random.default_rng(5)
    a, b = rng.uniform(1e-6, 1e-1, 500), np.exp(rng.normal(-6, 2, 500))
    merged = []
    for H in (J.Histogram, Histogram):
        ha, hb, hu = H(), H(), H()
        for v in a:
            ha.record(float(v))
        for v in b:
            hb.record(float(v))
        for v in np.concatenate([a, b]):
            hu.record(float(v))
        ha.merge(hb)
        assert ha.counts == hu.counts and ha.count == hu.count
        assert ha.total == pytest.approx(hu.total, rel=1e-12)  # sum order
        assert [ha.percentile(p) for p in (50, 99.9)] \
            == [hu.percentile(p) for p in (50, 99.9)]
        with pytest.raises(AssertionError):
            ha.merge(H(lo=1e-6))          # geometry mismatch refuses
        merged.append(_hist_state(ha))
    assert merged[0] == merged[1]


# ------------------------------------------------------ registry, exporters
def test_registry_snapshot_matches_reference(services):
    (js, jsvc, _), (ts, tsvc, _) = services
    snap = tsvc.metrics_snapshot()
    assert snap == jsvc.metrics_snapshot()
    prefixes = {k.split("{")[0].split("_")[0] for k in snap}
    for want in ("sync", "tree", "pipeline", "cache", "replication",
                 "read", "scheduler", "traces"):
        assert want in prefixes, want
    tm = tsvc.telemetry
    assert tm.value("sync_log_entries", src="primary") \
        == ts.sync_stats.log_entries \
        == sum(g.sync_stats.log_entries for g in ts.shards)
    assert tm.value("sync_bytes_synced", src="followers") \
        == ts.replication_stats.bytes_synced > 0
    assert tm.value("tree_puts") == ts.stats.puts
    assert tm.value("replication_feed_bytes") == ts.feed_stats.feed_bytes
    assert tm.value("scheduler_applied_writes") \
        == tsvc.scheduler.applied_writes
    assert tm.value("read_batches", op="get", backend="fused") \
        == jsvc.telemetry.value("read_batches", op="get", backend="fused")
    n_get = sum(1 for t in services[1][2] if t.op.KIND == "get")
    assert tm.registry.histogram("read_get_latency_seconds",
                                 layer="scheduler").count >= n_get


def test_prometheus_text_matches_reference(services):
    (_, jsvc, _), (_, tsvc, _) = services
    text = tsvc.prometheus()
    assert text.splitlines() == jsvc.prometheus().splitlines()
    parsed = parse_prometheus(text)
    assert parsed == J.parse_prometheus(text)
    assert prom_value(parsed, "hc_tree_puts") \
        == tsvc.telemetry.value("tree_puts")
    assert prom_value(parsed, "hc_read_scan_latency_seconds_count") > 0
    with pytest.raises(ValueError):
        parse_prometheus("not a metric line at all {")


def test_tracer_matches_reference(services):
    """The same rids are sampled, with the same span names and the same
    response stamps, and the Chrome trace events are equal."""
    (_, jsvc, jt), (_, tsvc, tt) = services

    def view(svc):
        return [(t.rid, t.kind, t.span_names(), t.tags, t.t0, t.t1,
                 [dataclasses.astuple(s) for s in t.spans])
                for t in svc.traces()]
    assert view(tsvc) == view(jsvc)
    assert tsvc.chrome_trace() == jsvc.chrome_trace()
    tr = tsvc.telemetry.tracer
    assert tr.sampled == len(tsvc.traces()) == (len(tt) + 120 + 3) // 4
    resp = {t.rid: t.result() for t in tt}
    for trace in tsvc.traces():
        names = trace.span_names()
        assert names[0] == "submit" and names[-1] == "resolve"
        assert names.index("export_stage") < names.index("flip")
        if trace.rid in resp:
            r = resp[trace.rid]
            assert (trace.tags["shard"], trace.tags["replica"],
                    trace.tags["serving_version"], trace.tags["status"]) \
                == (r.shard, r.replica, r.serving_version, r.status)


def test_tracer_deterministic_sampling():
    for TracerCls in (J.Tracer, Tracer):
        tr = TracerCls(sample_rate=0.25, capacity=16)
        live = [tr.begin(rid, "get") is not None for rid in range(12)]
        assert live == [True, False, False, False] * 3
        assert tr.live_count == 3 and tr.sampled == 3
        tr.span(1, "dispatch", 0.0, 1.0)      # unsampled: a no-op
        assert tr.finish(1) is None
        assert tr.collect()[0][:3] == ("traces_sampled", "counter", 3)


# ------------------------------------------------------- clock, wiring
def test_one_clock_everywhere():
    assert tshard._now is CLOCK and treplica._now is CLOCK
    assert tscheduler._now is CLOCK
    with CLOCK.frozen(100.0):
        assert tshard._now() == 100.0
        CLOCK.advance(2.5)
        assert treplica._now() == tscheduler._now() == 102.5
    t0 = CLOCK()
    assert CLOCK() >= t0


def test_merge_stats_matches_manual_field_sums():
    a = SyncStats(snapshots=2, bytes_synced=100, delta_fraction=0.25)
    b = SyncStats(snapshots=3, bytes_synced=50, delta_fraction=0.75)
    agg = merge_stats([a, b], SyncStats)
    assert agg.snapshots == 5 and agg.bytes_synced == 150
    assert agg.delta_fraction == 0.75


def _small_service(**telemetry):
    st = ShardedHoneycombStore(HoneycombConfig(**SMALL), heap_capacity=256,
                               shards=1, device="cpu")
    for i in range(32):
        st.put(int_key(i), b"v" * 8)
    return HoneycombService(st, batch_size=8,
                            telemetry=TelemetryConfig(**telemetry))


def test_disabled_telemetry_and_rate_zero():
    off = _small_service(enabled=False)
    assert off.telemetry is None and off.scheduler.telemetry is None
    off.submit(Put(int_key(1), b"x"))
    assert off.drain() and off.metrics_snapshot() == {}
    assert off.prometheus() == "" and off.traces() == []
    assert off.chrome_trace() == {"traceEvents": []}
    quiet = _small_service()
    assert quiet.telemetry is not None and quiet.telemetry.tracer is None
    quiet.submit_many(T.Get(int_key(i)) for i in range(8))
    quiet.drain()
    assert quiet.traces() == [] and quiet.scheduler._req_hist.count == 0


def test_trace_ring_buffer_bound():
    svc = _small_service(trace_sample_rate=1.0, trace_capacity=8)
    tickets = svc.submit_many(T.Get(int_key(i)) for i in range(20))
    svc.drain()
    assert [t.rid for t in svc.traces()] == [t.rid for t in tickets][-8:]
    assert svc.telemetry.tracer.sampled == 20
