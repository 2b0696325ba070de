"""The port's range-sharded router against the reference: a ``repro_torch``
ShardedHoneycombStore on the CPU and a ``repro.core`` one, fed the same
seeded ops, give equal GET/SCAN answers (cross-shard SCANs, empty shards,
the floor back-fill, boundary keys), equal per-shard routing counts and
load imbalance, and equal per-shard SyncStats, TreeStats, pipeline and
cache meters.  Integer results must be exactly equal."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import HoneycombConfig as JConfig
from repro.core import ShardedHoneycombStore as JSharded
from repro.core import ShardingConfig as JShardingConfig
from repro.core import uniform_int_boundaries as j_bounds
from repro_torch.core import HoneycombConfig as TConfig
from repro_torch.core import HoneycombStore as TStore
from repro_torch.core import ShardedHoneycombStore as TSharded
from repro_torch.core import ShardingConfig as TShardingConfig
from repro_torch.core import uniform_int_boundaries as t_bounds
from repro_torch.core.keys import int_key

SMALL = dict(node_cap=16, log_cap=4, n_shortcuts=4)
KEYSPACE = 200
PIPELINE_COUNTS = ("staged_exports", "flips", "dispatched_lanes",
                   "padded_lanes")


def _pair(shards, boundaries=None, **geometry):
    geometry = dict(SMALL, **geometry)
    j = JSharded(JConfig(**geometry), heap_capacity=256, shards=shards,
                 boundaries=boundaries)
    t = TSharded(TConfig(**geometry), heap_capacity=256, shards=shards,
                 boundaries=boundaries, device="cpu")
    return j, t


def _both(stores, op, *args, **kw):
    j, t = stores
    return getattr(j, op)(*args, **kw), getattr(t, op)(*args, **kw)


def _random_ops(stores, rng, n, oracle):
    for _ in range(n):
        k = int_key(int(rng.integers(0, KEYSPACE)))
        roll = rng.random()
        if roll < 0.5:
            v = bytes(rng.integers(65, 91, int(rng.integers(0, 13))))
            _both(stores, "put", k, v)
            oracle[k] = v
        elif roll < 0.75:
            v = bytes(rng.integers(97, 123, 8))
            _both(stores, "update", k, v)
            oracle[k] = v
        else:
            _both(stores, "delete", k)
            oracle.pop(k, None)


def _assert_meters_equal(j, t):
    assert t.shard_ops == j.shard_ops
    assert t.load_imbalance == j.load_imbalance
    assert [dataclasses.asdict(s) for s in t.per_shard_sync_stats] \
        == [dataclasses.asdict(s) for s in j.per_shard_sync_stats]
    assert dataclasses.asdict(t.sync_stats) == dataclasses.asdict(j.sync_stats)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert dataclasses.asdict(t.cache_stats) \
        == dataclasses.asdict(j.cache_stats)
    for f in PIPELINE_COUNTS:
        assert getattr(t.pipeline_stats, f) == getattr(j.pipeline_stats, f)
    assert t.per_shard_epochs == j.per_shard_epochs


@pytest.mark.parametrize("shards", [1, 3])
def test_router_matches_reference(shards):
    """Random puts/updates/deletes over rounds; every batch answer, the
    host-side facade and every meter agree, including SCANs spanning
    every shard."""
    bounds = j_bounds(KEYSPACE, shards) if shards > 1 else None
    stores = _pair(shards, bounds)
    j, t = stores
    oracle = {}
    rng = np.random.default_rng(shards)
    for rnd in range(4):
        _random_ops(stores, rng, 70, oracle)
        if rnd % 2:
            assert t.collect_garbage() == j.collect_garbage()
        keys = [int_key(int(i)) for i in rng.integers(0, KEYSPACE + 20, 29)]
        jg, tg = _both(stores, "get_batch", keys)
        assert tg == jg == [oracle.get(k) for k in keys]
        los = rng.integers(0, KEYSPACE, 11)
        ranges = [(int_key(int(a)), int_key(int(a + w))) for a, w in
                  zip(los, rng.choice([0, 5, 40, 150], 11))]
        ranges.append((int_key(3), int_key(KEYSPACE - 3)))   # every shard
        js, ts = _both(stores, "scan_batch", ranges)
        assert ts == js
        jh, th = _both(stores, "scan", int_key(5), int_key(190), 17)
        assert th == jh
        _both(stores, "export_snapshot")
        _assert_meters_equal(j, t)
    assert t.sync_stats.delta_syncs > 0
    t.check_invariants()


def test_router_single_shard_equals_unsharded_port_store():
    """shards=1 is op-for-op the port's own HoneycombStore."""
    t = TSharded(TConfig(**SMALL), heap_capacity=256, device="cpu")
    u = TStore(TConfig(**SMALL), heap_capacity=256, device="cpu")
    oracle = {}
    rng = np.random.default_rng(9)
    for _ in range(3):
        _random_ops((u, t), rng, 60, oracle)
        keys = [int_key(i) for i in range(0, KEYSPACE, 7)]
        assert t.get_batch(keys) == u.get_batch(keys)
        ranges = [(int_key(a), int_key(a + 9)) for a in range(0, 180, 31)]
        assert t.scan_batch(ranges) == u.scan_batch(ranges)
        t.export_snapshot()
        u.export_snapshot()
        assert t.sync_stats == u.sync_stats


def test_router_empty_shards_and_floor_backfill():
    """Shards holding no keys answer cleanly, and the global floor item is
    back-filled from the nearest non-empty shard to the left, across an
    empty shard; both packages dispatch the same back-fill batches."""
    bounds = j_bounds(KEYSPACE, 4)
    stores = _pair(4, bounds)
    j, t = stores
    for i in range(40):                       # shard 0 only (keys < 50)
        _both(stores, "put", int_key(i), b"v%d" % i)
    _both(stores, "export_snapshot")
    jg, tg = _both(stores, "get_batch",
                   [int_key(60), int_key(120), int_key(180)])
    assert tg == jg == [None, None, None]
    ranges = [(int_key(120), int_key(190)), (int_key(55), int_key(80)),
              (int_key(10), int_key(199)), (int_key(160), int_key(160))]
    js, ts = _both(stores, "scan_batch", ranges)
    assert ts == js
    assert ts[0] == [(int_key(39), b"v39")]
    _assert_meters_equal(j, t)
    empty = _pair(4, bounds)
    _both(empty, "export_snapshot")
    assert _both(empty, "scan_batch", [(int_key(60), int_key(190))]) \
        == ([[]], [[]])
    assert empty[1].scan(int_key(0), int_key(199)) == []


def test_router_boundary_keys_route_and_scan_once():
    """A key equal to a shard boundary belongs to the upper shard and
    shows up once in a cross-boundary SCAN."""
    bounds = j_bounds(KEYSPACE, 4)
    stores = _pair(4, bounds)
    j, t = stores
    for b in bounds:
        assert t.shard_for_key(b) == j.shard_for_key(b)
        _both(stores, "put", b, b"edge")
    _both(stores, "put", int_key(49), b"below")
    _both(stores, "export_snapshot")
    js, ts = _both(stores, "scan_batch", [(int_key(0), int_key(199))])
    assert ts == js
    assert ts[0] == [(int_key(49), b"below")] + [(k, b"edge")
                                                 for k in bounds]
    _assert_meters_equal(j, t)


def test_router_deferred_sync_under_every_k():
    """A write burst inside ``deferred_sync`` takes no policy auto-sync;
    both packages then sync and count alike."""
    stores = _pair(2, j_bounds(KEYSPACE, 2), sync_policy="every_k",
                   sync_every_k=8)
    j, t = stores
    rng = np.random.default_rng(4)
    oracle = {}
    _random_ops(stores, rng, 40, oracle)
    with j.deferred_sync(), t.deferred_sync():
        _random_ops(stores, rng, 40, oracle)
        _assert_meters_equal(j, t)
    _both(stores, "export_snapshot")
    keys = [int_key(i) for i in range(0, KEYSPACE, 3)]
    jg, tg = _both(stores, "get_batch", keys)
    assert tg == jg == [oracle.get(k) for k in keys]
    _assert_meters_equal(j, t)


def test_router_configs_match_reference():
    for n, shards in ((200, 2), (2 ** 18, 2), (2 ** 64, 5), (7, 3)):
        assert t_bounds(n, shards) == j_bounds(n, shards)
    cfg = TShardingConfig(3, t_bounds(90, 3))
    assert dataclasses.astuple(cfg) \
        == dataclasses.astuple(JShardingConfig(3, j_bounds(90, 3)))
    for bad in (dict(shards=0), dict(shards=2, boundaries=()),
                dict(shards=3, boundaries=(b"b", b"a"))):
        with pytest.raises(AssertionError):
            JShardingConfig(**bad)
        with pytest.raises(AssertionError):
            TShardingConfig(**bad)
    j = JSharded(JConfig(**SMALL), shards=3)
    t = TSharded(TConfig(**SMALL), shards=3, device="cpu")
    assert t.boundaries == j.boundaries


def test_router_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TSharded()
    with pytest.raises(RuntimeError):
        TSharded(TConfig(**SMALL), shards=2)
