"""The port's service front end against the reference: ``HoneycombService``
over the out-of-order scheduler (serial and pipelined) and the
``routing()`` accessors, on replicated, sharded stores in both snapshot
layouts.  The same seeded ops go through a ``repro_torch`` store on the
CPU and a ``repro.core`` store, both packages' clocks frozen: every
``Response`` field, the scheduler's and the stores' ``PipelineStats``,
``SyncStats``, ``FeedStats`` and the dispatch stamps must be exactly
equal.  Also mirrored from the reference's own tests: in-order delivery
and cost bucketing, the interior cache's load balancer, tickets, the
serial epoch against the plain ``deferred_sync`` sequence, and the
service against the direct facade."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import api as japi
import repro_torch.core as T
from repro.core.cache import InteriorCache as JCache
from repro_torch.core import (Delete, Get, HoneycombConfig, HoneycombService,
                              HoneycombStore, OutOfOrderScheduler, Put,
                              ReplicaGroup, ReplicationConfig, Scan,
                              ServiceConfig, ShardedHoneycombStore,
                              StoreShard, Update, uniform_int_boundaries)
from repro_torch.core import scheduler as tscheduler
from repro_torch.core.cache import InteriorCache as TCache
from repro_torch.core.keys import int_key

SMALL = dict(node_cap=16, log_cap=4, n_shortcuts=4)
KEYSPACE = 200
WALL = ("admit_s", "export_s", "dispatch_s", "sync_stall_s")


def random_ops(rng, n, key_space=KEYSPACE, api=T):
    """One randomized GET/SCAN/PUT/UPDATE/DELETE mix as typed ops."""
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, key_space))
        p = rng.random()
        if p < 0.25:
            ops.append(api.Put(int_key(k), b"v%03d" % k))
        elif p < 0.35:
            ops.append(api.Update(int_key(k), b"u%03d" % k))
        elif p < 0.45:
            ops.append(api.Delete(int_key(k)))
        elif p < 0.8:
            ops.append(api.Get(int_key(k)))
        else:
            ops.append(api.Scan(int_key(k),
                                int_key(min(k + 7, key_space - 1)),
                                expected_items=8))
    return ops


def as_reference(op):
    """The reference package's op of the same kind and fields."""
    return japi.OPS_BY_KIND[op.KIND](*dataclasses.astuple(op))


def _stats(s, drop=()):
    d = dataclasses.asdict(s)
    for k in drop:
        d.pop(k)
    return d


def _sharded(P, layout, shards=2, replicas=2, **kw):
    return P.ShardedHoneycombStore(
        P.HoneycombConfig(layout=layout, **SMALL), heap_capacity=256,
        shards=shards, boundaries=uniform_int_boundaries(KEYSPACE, shards),
        replication=P.ReplicationConfig(replicas, "round_robin"), **kw)


# ------------------------------------------------- the service, both sides
@pytest.mark.parametrize("layout", ["packed", "legacy"])
@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_service_matches_reference(layout, pipeline):
    """2 shards x 2 replicas through HoneycombService: every Response
    field, the scheduler's PipelineStats (wall times aside), the stores'
    SyncStats, follower SyncStats, FeedStats, replica meters and the last
    dispatch stamps equal the reference's, round after round."""
    with J.CLOCK.frozen(), T.CLOCK.frozen():
        js = _sharded(J, layout)
        ts = _sharded(T, layout, device="cpu")
        jsvc = J.HoneycombService(js, batch_size=8, pipeline=pipeline)
        tsvc = HoneycombService(ts, batch_size=8, pipeline=pipeline)
        rng = np.random.default_rng(21)
        for round_ in range(4):
            ops = random_ops(rng, 70)
            jt = jsvc.submit_many(as_reference(op) for op in ops)
            tt = tsvc.submit_many(ops)
            jout, tout = jsvc.drain(), tsvc.drain()
            assert sorted(tout) == sorted(jout) == [t.rid for t in tt]
            for a, b in zip(jt, tt):
                assert a.rid == b.rid and a.done and b.done
                assert dataclasses.astuple(b.result()) \
                    == dataclasses.astuple(a.result()), (round_, b.op)
            assert _stats(tsvc.stats, WALL) == _stats(jsvc.stats, WALL)
            assert _stats(ts.pipeline_stats, WALL) \
                == _stats(js.pipeline_stats, WALL)
            assert _stats(ts.sync_stats) == _stats(js.sync_stats), round_
            assert _stats(ts.replication_stats) \
                == _stats(js.replication_stats)
            assert _stats(ts.feed_stats) == _stats(js.feed_stats), round_
            assert ts.per_shard_replica_ops == js.per_shard_replica_ops
            assert ts.per_shard_epochs == js.per_shard_epochs
            assert [g.last_dispatch for g in ts.shards] \
                == [tuple(map(int, g.last_dispatch)) for g in js.shards]
            for name in ("dispatched_batches", "dispatched_requests",
                         "applied_writes", "syncs"):
                assert getattr(tsvc.scheduler, name) \
                    == getattr(jsvc.scheduler, name), name
    assert ts.sync_stats.delta_syncs > 0
    assert {r.replica for r in tout.values() if r.items is not None} \
        | {r.replica for r in tout.values() if r.value is not None} \
        == {0, 1}


def test_serial_wait_is_a_device_sync_only_on_cuda(monkeypatch):
    """Serial mode waits for the device with torch.cuda.synchronize on the
    CUDA devices its snapshots lie on, and not at all for CPU tensors."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    st = HoneycombStore(HoneycombConfig(**SMALL), heap_capacity=64,
                        device="cpu")
    svc = HoneycombService(st, batch_size=4, pipeline="serial")
    svc.submit(Put(int_key(1), b"a"))
    assert svc.submit(Get(int_key(1))).result().value == b"a"
    assert calls == [] and svc.syncs == 1
    tscheduler._block_until_ready(None)
    tscheduler._block_until_ready([st._snapshot, None])
    assert calls == []


# ------------------------------------------- scheduler (test_scheduler_cache)
def test_scheduler_in_order_delivery():
    """Mirrors the reference's in-order delivery test on both packages:
    the same rids resolve to the same answers, which equal the tree's."""
    outs = []
    for P, kw in ((J, {}), (T, dict(device="cpu"))):
        store = P.HoneycombStore(P.HoneycombConfig(**SMALL),
                                 heap_capacity=256, **kw)
        for i in range(100):
            store.put(int_key(i), b"v%d" % i)
        sched = P.OutOfOrderScheduler(batch_size=8)
        rids = {}
        rng = np.random.default_rng(0)
        for _ in range(20):
            k = int(rng.integers(0, 100))
            rids[sched.submit("get", int_key(k))] = k
        for _ in range(10):
            a = int(rng.integers(0, 90))
            rids[sched.submit("scan", int_key(a), int_key(a + 3),
                              expected_items=4)] = (a, a + 3)
        out = sched.run(store)
        assert set(out) == set(rids)
        for rid, spec in rids.items():
            if isinstance(spec, int):
                assert out[rid] == b"v%d" % spec
            else:
                assert out[rid] == store.tree.scan(int_key(spec[0]),
                                                   int_key(spec[1]))
        assert sched.dispatched_requests == 30
        outs.append(out)
    assert outs[0] == outs[1]


def test_scheduler_cost_bucketing():
    sizes = []
    for P in (J, T):
        sched = P.OutOfOrderScheduler(batch_size=4, cost_classes=(1, 16))
        for _ in range(6):
            sched.submit("scan", b"a", b"b", expected_items=1)
        for _ in range(3):
            sched.submit("scan", b"a", b"b", expected_items=10)
        batches = list(sched.ready_batches(flush=True))
        sizes.append([(k, [r.rid for r in b]) for k, b in batches])
    assert sizes[0] == sizes[1]
    assert sorted(len(b) for _, b in sizes[1]) == [2, 3, 4]
    with pytest.raises(AssertionError):
        OutOfOrderScheduler(pipeline="warp")
    with pytest.raises(AssertionError):
        OutOfOrderScheduler().submit("upsert", b"k")


# ---------------------------------------- interior cache and load balancer
@pytest.mark.parametrize("case", ["lb", "no_lb", "inflight", "invalidate"])
def test_cache_load_balancer_matches_reference(case):
    """The host load balancer routes the same lookups down the same pipes
    as the reference (the same seeded eviction and coin), with equal
    CacheStats; mirrors tests/test_scheduler_cache.py."""
    paths, stats = [], []
    for P, Cache in ((J, JCache), (T, TCache)):
        if case == "lb":
            c = Cache(P.HoneycombConfig(cache_slots=64, load_balance=True,
                                        lb_fast_fraction=0.6))
            for lid in range(32):
                c.lookup(lid, lid)
            got = [c.route(lid, lid, nbytes=1024)
                   for _ in range(200) for lid in range(32)]
        elif case == "no_lb":
            c = Cache(P.HoneycombConfig(cache_slots=64, load_balance=False))
            for lid in range(8):
                c.lookup(lid, lid)
            got = [c.route(lid, lid, nbytes=512)
                   for _ in range(50) for lid in range(8)]
        elif case == "inflight":
            c = Cache(P.HoneycombConfig(cache_slots=64, load_balance=True))
            c.lookup(1, 1)
            got = [c.route(1, 1, 64, fast_inflight=100, slow_inflight=0),
                   c.route(1, 1, 64, fast_inflight=0, slow_inflight=100),
                   c.route(99, 7, 64)]
        else:
            c = Cache(P.HoneycombConfig(cache_slots=16, cache_ways=4,
                                        load_balance=False))
            got = [c.lookup(5, phys=100), c.lookup(5, phys=100),
                   c.lookup(5, phys=200)]
            for lid in range(5, 100, 4):     # overfill set 1: evictions
                got.append(c.lookup(lid, lid))
            c.invalidate(5)
        paths.append(got)
        stats.append(dataclasses.asdict(c.stats))
    assert paths[0] == paths[1] and stats[0] == stats[1]
    s = stats[1]
    if case == "lb":
        frac = s["fast_path_reads"] / (s["fast_path_reads"]
                                       + s["slow_path_reads"])
        assert s["slow_path_reads"] > 0 and 0.4 < frac < 0.8
    elif case == "no_lb":
        assert s["slow_path_reads"] == 0 and s["fast_path_reads"] == 400
    elif case == "inflight":
        assert paths[1] == ["slow", "fast", "slow"]
    else:
        assert paths[1][:3] == [False, True, False]
        assert s["invalidations"] >= 1


# ------------------------------------------------------- service mechanics
def test_ticket_result_drains_on_demand_and_pending_counts():
    st = HoneycombStore(HoneycombConfig(**SMALL), heap_capacity=256,
                        device="cpu")
    svc = HoneycombService(st)
    svc.submit(Put(int_key(5), b"v"))
    t = svc.submit(Get(int_key(5)))
    assert not t.done and svc.pending == 2
    assert t.result().value == b"v"        # implicit drain
    assert t.done and svc.pending == 0
    assert t.result() is t.result()        # resolved once, cached
    assert t.result().ok and t.result().status == T.OK
    miss = svc.submit(Get(int_key(6))).result()
    assert miss.status == T.NOT_FOUND and miss.unwrap() is None


def test_service_config_validation():
    for P in (J, T):
        with pytest.raises(AssertionError):
            P.ServiceConfig(pipeline="warp")
        with pytest.raises(AssertionError):
            P.ServiceConfig(batch_size=0)
        with pytest.raises(AssertionError):
            P.TelemetryConfig(trace_sample_rate=1.5)
    assert dataclasses.asdict(T.ServiceConfig()) \
        == dataclasses.asdict(J.ServiceConfig())
    st = HoneycombStore(HoneycombConfig(**SMALL), heap_capacity=256,
                        device="cpu")
    svc = HoneycombService(st, cfg=ServiceConfig(batch_size=16),
                           pipeline="pipelined")
    assert svc.cfg.batch_size == 16 and svc.cfg.pipeline == "pipelined"


def test_serial_run_matches_deferred_sync_sequence():
    """pipeline="serial" is op-for-op the plain sequence: writes under
    ``deferred_sync``, ONE facade ``export_snapshot()``, then the read
    batches in ``ready_batches`` order — same responses, same SyncStats
    (mirrors tests/test_pipeline_engine.py)."""
    mk = lambda: ShardedHoneycombStore(        # noqa: E731
        HoneycombConfig(layout="legacy", **SMALL), heap_capacity=256,
        shards=4, boundaries=uniform_int_boundaries(KEYSPACE, 4),
        device="cpu")
    a, b = mk(), mk()
    sched = OutOfOrderScheduler(batch_size=8, routing=a.routing(),
                                pipeline="serial")
    plain = OutOfOrderScheduler(batch_size=8, routing=b.routing())
    rng = np.random.default_rng(5)
    for op in random_ops(rng, 90):
        sched.submit_op(op)
        plain.submit_op(op)
    out = sched.run(a)
    want = {}
    with b.deferred_sync():
        for r in plain._writes:
            r.op.apply(b)
            want[r.rid] = None
    plain._writes.clear()
    b.export_snapshot()
    for kind, batch in plain.ready_batches(flush=True):
        if kind == "get":
            res = b.get_batch([r.key for r in batch])
        else:
            res = b.scan_batch([(r.key, r.hi) for r in batch])
        for r, v in zip(batch, res):
            want[r.rid] = v
    assert out == want
    assert a.sync_stats == b.sync_stats and sched.syncs == 4


@pytest.mark.parametrize("shards,replicas,pipeline",
                         [(s, r, p) for s in (1, 3) for r in (1, 2)
                          for p in ("serial", "pipelined")])
def test_service_equals_direct_facade(shards, replicas, pipeline):
    """A randomized mix through the service returns exactly what direct
    facade calls on a twin store give, across the {shards} x {replicas} x
    {pipeline} grid (mirrors tests/test_api.py)."""
    def make():
        if shards == 1 and replicas == 1:
            return HoneycombStore(HoneycombConfig(**SMALL),
                                  heap_capacity=256, device="cpu")
        return ShardedHoneycombStore(
            HoneycombConfig(**SMALL), heap_capacity=256, shards=shards,
            boundaries=(uniform_int_boundaries(KEYSPACE, shards)
                        if shards > 1 else None),
            replication=ReplicationConfig(
                replicas, "round_robin" if replicas > 1 else "primary_only"),
            device="cpu")
    svc_store, ref = make(), make()
    svc = HoneycombService(svc_store, batch_size=8, pipeline=pipeline)
    rng = np.random.default_rng(1000 + shards * 10 + replicas)
    for round_ in range(3):
        ops = random_ops(rng, 40)
        tickets = svc.submit_many(ops)
        svc.drain()
        for op in ops:
            if op.IS_WRITE:
                op.apply(ref)
        ref.export_snapshot()
        # every read of the epoch answers from the one synced snapshot
        gets = iter(ref.get_batch([op.key for op in ops
                                   if isinstance(op, Get)]))
        scans = iter(ref.scan_batch([(op.lo, op.hi) for op in ops
                                     if isinstance(op, Scan)]))
        for op, t in zip(ops, tickets):
            w = (next(gets) if isinstance(op, Get) else next(scans)
                 if isinstance(op, Scan) else None)
            r = t.result()
            assert r.unwrap() == w, (round_, op)
            if isinstance(op, Get):
                assert r.ok == (w is not None)
                assert 0 <= r.replica < replicas
                assert r.shard == svc.routing.shard_of(op.key)
    assert svc_store.sync_stats == ref.sync_stats


def _assert_monotone(records):
    """Per key, serving-version stamps never regress in rid order."""
    last: dict = {}
    for rid, key, resp in sorted(records, key=lambda t: t[0]):
        prev = last.get(key)
        assert prev is None or resp.serving_version >= prev, (rid, key)
        last[key] = resp.serving_version


@pytest.mark.parametrize("layout", ["packed", "legacy"])
def test_serving_version_monotone_and_covers_primary(layout):
    """Stamps are monotone per key, every follower answer covers the
    primary's serving version, and a follower that lags after its pin was
    assigned is skipped with a fresh stamp (mirrors tests/test_api.py)."""
    st = ShardedHoneycombStore(
        HoneycombConfig(layout=layout, **SMALL), heap_capacity=256,
        shards=1, replication=ReplicationConfig(3, "round_robin"),
        device="cpu")
    svc = HoneycombService(st, batch_size=4)
    group = st.shards[0]
    records, follower_answers = [], 0
    rng = np.random.default_rng(7)
    for round_ in range(4):
        keys = [int(k) for k in rng.integers(0, 100, 12)]
        svc.submit_many([Put(int_key(k), b"r%d-%03d" % (round_, k))
                         for k in keys])
        tickets = [(svc.submit(Get(int_key(k))), k) for k in keys]
        svc.drain()
        prim_v = group.primary.serving_version
        for t, k in tickets:
            r = t.result()
            records.append((t.rid, k, r))
            assert r.value == b"r%d-%03d" % (round_, k)
            assert r.serving_version >= prim_v
            follower_answers += r.replica > 0
    assert follower_answers > 0
    tickets = [(svc.submit(Get(int_key(k))), k) for k in range(0, 100, 9)]
    group.pause_follower(1)
    group.pause_follower(2)
    for k in range(0, 100, 9):
        st.put(int_key(k), b"fresh%03d" % k)
    st.export_snapshot()                   # the followers miss this epoch
    skips0 = st.lagging_skips
    svc.drain()
    assert st.lagging_skips > skips0
    for t, k in tickets:
        r = t.result()
        records.append((t.rid, k, r))
        assert r.replica == 0 and r.value == b"fresh%03d" % k
        assert r.serving_version >= group.primary.serving_version
    _assert_monotone(records)


def test_service_wraps_every_facade_layer():
    """routing() comes from all three layers — plain store, bare replica
    group, sharded router — and the service self-wires each; a write's
    stamp is its visibility version."""
    plain = HoneycombStore(HoneycombConfig(**SMALL), heap_capacity=256,
                           device="cpu")
    s1 = HoneycombService(plain, batch_size=4)
    w = s1.submit(Put(int_key(1), b"a"))
    s1.submit_many([Put(int_key(i), b"p%d" % i) for i in range(2, 20)])
    t = s1.submit(Get(int_key(7)))
    assert t.result().value == b"p7"
    assert w.result().ok and w.result().serving_version > 0
    assert t.result().serving_version >= w.result().serving_version
    assert t.result().shard == 0 and t.result().replica == 0
    group = ReplicaGroup(StoreShard(HoneycombConfig(layout="legacy",
                                                    **SMALL),
                                    heap_capacity=256, device="cpu"),
                         ReplicationConfig(2, "round_robin"))
    s2 = HoneycombService(group, batch_size=4)
    s2.submit_many([Put(int_key(i), b"g%d" % i) for i in range(40)])
    s2.drain()
    tickets = s2.submit_many([Get(int_key(i)) for i in range(0, 40, 2)])
    s2.drain()
    assert [t.result().value for t in tickets] \
        == [b"g%d" % i for i in range(0, 40, 2)]
    assert {t.result().replica for t in tickets} == {0, 1}
    sh = ShardedHoneycombStore(HoneycombConfig(**SMALL), heap_capacity=256,
                               shards=3,
                               boundaries=uniform_int_boundaries(KEYSPACE, 3),
                               device="cpu")
    s3 = HoneycombService(sh, batch_size=4)
    s3.submit_many([Put(int_key(i), b"s%d" % i) for i in range(0, 200, 5)])
    s3.submit_many([Update(int_key(5), b"x"), Delete(int_key(10))])
    span = s3.submit(Scan(int_key(1), int_key(198), expected_items=32))
    got = span.result()
    assert got.ok and len(got.items) > 0
    assert got.items == sh.scan_batch([(int_key(1), int_key(198))])[0]
