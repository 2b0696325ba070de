"""The port's replication against the reference: the op wire codec, the
relay topology, the log-replay layout and marshalling, the plain
log-replay scatter, and the replicated store (both follower feeds, flat
and relay-tree topologies, the three read-spreading policies, the
freshness rule, fallback epochs and catch-ups).  A ``repro_torch`` store
on the CPU and a ``repro.core`` store are fed the same seeded ops; answers,
``last_dispatch`` stamps, ``FeedStats``, per-replica ``SyncStats``, the lag
meters and every follower's image must be exactly equal."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import config as jconfig
from repro.core import FeedTopology as JTopology
from repro.core import HoneycombConfig as JConfig
from repro.core import ReplicationConfig as JReplication
from repro.core import ShardedHoneycombStore as JSharded
from repro.core import uniform_int_boundaries
from repro.core.schema import NodeImageLayout as JLayout
from repro.kernels import ops as jops
from repro_torch.core import api as tapi
from repro_torch.core import config as tconfig
from repro_torch.core import FeedTopology as TTopology
from repro_torch.core import HoneycombConfig as TConfig
from repro_torch.core import HoneycombStore as TStore
from repro_torch.core import ReplicationConfig as TReplication
from repro_torch.core import ShardedHoneycombStore as TSharded
from repro_torch.core.keys import int_key
from repro_torch.core.schema import NodeImageLayout as TLayout
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SMALL = dict(node_cap=16, log_cap=4, n_shortcuts=4)
KEYSPACE = 200


# ------------------------------------------------------------ wire codec
def _ops(api):
    big = b"\xff" * 0xFFFF
    return [api.Get(b"k1"), api.Get(b""), api.Scan(b"a", b"z", 7),
            api.Scan(b"", b"", 0), api.Scan(b"lo", b"hi", 0xFFFF),
            api.Put(b"k", b"v" * 16), api.Put(b"k", b""), api.Put(big, b"x"),
            api.Update(b"k2", b"value"), api.Update(b"k", b""),
            api.Delete(b"k3"), api.Delete(big)]


def test_wire_codec_matches_reference():
    """Identical bytes for all five ops (zero-length values, max-u16 keys),
    a stream round-trips to equal ops, and the shared constants agree."""
    jops_, tops_ = _ops(japi), _ops(tapi)
    for j, t in zip(jops_, tops_):
        assert t.encode_wire() == j.encode_wire()
        assert (t.KIND, t.OP_CODE, t.IS_WRITE) \
            == (j.KIND, j.OP_CODE, j.IS_WRITE)
    stream = b"".join(op.encode_wire() for op in tops_)
    assert tapi.decode_wire_stream(stream) == tops_
    assert [dataclasses.astuple(op) for op in
            japi.decode_wire_stream(stream)] \
        == [dataclasses.astuple(op) for op in tops_]
    op, nxt = tapi.decode_wire(stream, 0)
    assert op == tops_[0] and nxt == len(tops_[0].encode_wire())
    assert list(tapi.OPS_BY_KIND) == list(japi.OPS_BY_KIND)
    assert tapi.WRITE_KINDS == japi.WRITE_KINDS
    for op in tops_:
        if op.IS_WRITE:
            val = getattr(op, "value", b"")
            assert len(op.encode_wire()) == tapi.wire_entry_nbytes(op.key,
                                                                    val)


@pytest.mark.parametrize("buf", [
    b"\x03\x00",                                # truncated header
    b"\x09\x00\x01\x00\x00k",                   # unknown op code
    b"\x03\x00\x05\x00\x01abc",                 # truncated payload
    b"\x02\x00\x01\x00\x01ab",                  # SCAN missing its u16 tail
    b"\x01\x00\x01\x00\x00k\x00",               # good entry + garbage
])
def test_wire_decode_rejects_bad_buffers(buf):
    with pytest.raises(japi.WireDecodeError):
        japi.decode_wire_stream(buf)
    with pytest.raises(tapi.WireDecodeError):
        tapi.decode_wire_stream(buf)


# ------------------------------------------------ layout and marshalling
def test_feed_topology_and_replication_config_match_reference():
    for fanout in (1, 2, 3):
        for depth in (0, 1, 2, 3):
            for n in range(0, 11):
                assert TTopology(fanout, depth).parents(n) \
                    == JTopology(fanout, depth).parents(n), (fanout, depth, n)
    assert tconfig.REPLICA_FEEDS == jconfig.REPLICA_FEEDS
    assert tconfig.REPLICA_POLICIES == jconfig.REPLICA_POLICIES
    for bad in (dict(replicas=0), dict(policy="random"), dict(feed="wal")):
        with pytest.raises(AssertionError):
            JReplication(**bad)
        with pytest.raises(AssertionError):
            TReplication(**bad)


@pytest.mark.parametrize("geometry", [{}, SMALL,
                                      dict(key_words=3, val_words=2)])
def test_log_replay_layout_and_packing_match_reference(geometry):
    jl = JLayout.for_config(JConfig(**geometry))
    tl = TLayout.for_config(TConfig(**geometry))
    assert tuple(tl.log_replay_offsets()) == tuple(jl.log_replay_offsets())
    assert tl.log_entry_words == jl.log_entry_words
    assert tl.log_replay_offsets().log_cap == JConfig(**geometry).log_cap
    rng = np.random.default_rng(5)
    cfg = TConfig(**geometry)
    n = 9
    keys = [rng.bytes(int(rng.integers(0, cfg.max_key_bytes + 1)))
            for _ in range(n)]
    vals = [rng.bytes(int(rng.integers(0, cfg.max_inline_val_bytes + 1)))
            for _ in range(n)]
    kinds = ["put", "update", "delete"]
    t_ops, j_ops, codes = [], [], []
    for i, (k, v) in enumerate(zip(keys, vals)):
        kind = kinds[i % 3]
        t_ops.append(tapi.Delete(k) if kind == "delete"
                     else tapi.OPS_BY_KIND[kind](k, v))
        j_ops.append(japi.Delete(k) if kind == "delete"
                     else japi.OPS_BY_KIND[kind](k, v))
        codes.append(i % 3)
    backptrs = np.array([-1, 0, 5, -7, 2 ** 31 - 1, -2 ** 31, 3, 1, 0],
                        np.int32)
    hints = rng.integers(0, 256, n).astype(np.int32)
    vdeltas = np.array([0, 1, 2 ** 33 + 5, -3, 2 ** 40, -2 ** 35 - 1,
                        2 ** 31, 2 ** 32 - 1, 7], np.int64)
    want = jl.pack_log_entries(j_ops, codes, backptrs, hints, vdeltas)
    got = tl.pack_log_entries(t_ops, codes, backptrs, hints, vdeltas)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- plain log replay
def _replay_inputs(seed, n_entries, S=32, log_cap=16):
    """Random image and entries with distinct, per-row monotone slots that
    continue from a random base, padded with repeats of the last record
    (the store's pow2 bucketing)."""
    cfg = dict(node_cap=16, log_cap=log_cap, n_shortcuts=4)
    layout = TLayout.for_config(TConfig(**cfg))
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 2 ** 32, (S, layout.image_words),
                         dtype=np.uint32)
    pool = rng.choice(S, 8, replace=False)
    rows = rng.choice(pool, n_entries).astype(np.int32)
    base = {int(r): int(rng.integers(0, 3)) for r in pool}
    count = dict.fromkeys(base, 0)
    slots = np.empty(n_entries, np.int32)
    for i, r in enumerate(rows.tolist()):
        slots[i] = base[r] + count[r]
        count[r] += 1
    entries = rng.integers(0, 2 ** 32, (n_entries, layout.log_entry_words),
                           dtype=np.uint32)
    rows = np.concatenate([rows, np.repeat(rows[-1:], 3)])
    slots = np.concatenate([slots, np.repeat(slots[-1:], 3)])
    entries = np.concatenate([entries, np.repeat(entries[-1:], 3, axis=0)])
    return cfg, image, rows, slots, entries


def _replay_both(cfg, image, rows, slots, entries):
    """(reference oracle, reference Pallas body in interpret mode, port's
    plain version), each as a u32 numpy image."""
    offs_j = JLayout.for_config(JConfig(**cfg)).log_replay_offsets()
    offs_t = TLayout.for_config(TConfig(**cfg)).log_replay_offsets()
    jargs = (jnp.asarray(image), jnp.asarray(rows), jnp.asarray(slots),
             jnp.asarray(entries))
    j_ref = np.asarray(jops.log_replay_scatter(*jargs, offs=offs_j,
                                               backend="ref"))
    j_itp = np.asarray(jops.log_replay_scatter(*jargs, offs=offs_j,
                                               backend="interpret"))
    timg = torch.from_numpy(image.view(np.int32).copy())
    got = tops.log_replay_scatter(
        timg, torch.from_numpy(rows), torch.from_numpy(slots),
        torch.from_numpy(entries.view(np.int32).copy()), offs=offs_t)
    assert got is timg                         # in place
    return j_ref, j_itp, got.numpy().view(np.uint32), offs_t


@pytest.mark.parametrize("seed,n_entries", [(0, 7), (1, 16), (2, 48)])
def test_plain_log_replay_matches_reference(seed, n_entries):
    j_ref, j_itp, got, offs = _replay_both(*_replay_inputs(seed, n_entries))
    np.testing.assert_array_equal(got, j_ref)
    np.testing.assert_array_equal(got, j_itp)


def test_plain_log_replay_sets_nlog_below_an_old_count():
    """A row whose old nlog lies above every new slot gets nlog = its
    highest new slot + 1, as in the reference (set, not maxed)."""
    cfg, image, rows, slots, entries = _replay_inputs(3, 5)
    offs = TLayout.for_config(TConfig(**cfg)).log_replay_offsets()
    rows[:] = 4
    slots[:] = [0, 1, 2, 2, 2, 2, 2, 2]
    entries[3:] = entries[2]
    image[4, offs.nlog] = 15
    j_ref, j_itp, got, _ = _replay_both(cfg, image, rows, slots, entries)
    np.testing.assert_array_equal(got, j_ref)
    np.testing.assert_array_equal(got, j_itp)
    assert got[4, offs.nlog] == 3


@pytest.mark.parametrize("row,slot", [(32, 0), (-33, 0), (1, -1), (1, 16)])
def test_plain_log_replay_rejects_bad_rows_and_slots(row, slot):
    """A row outside [-S, S) or a slot outside [0, log_cap) raises before
    anything is written (the reference's flat indexing would silently
    write into another row or field)."""
    cfg, image, rows, slots, entries = _replay_inputs(4, 3)
    offs = TLayout.for_config(TConfig(**cfg)).log_replay_offsets()
    rows[1], slots[1] = row, slot
    timg = torch.from_numpy(image.view(np.int32).copy())
    with pytest.raises(IndexError):
        tref.log_replay_scatter_ref(
            timg, torch.from_numpy(rows), torch.from_numpy(slots),
            torch.from_numpy(entries.view(np.int32).copy()), offs=offs)
    assert np.array_equal(timg.numpy().view(np.uint32), image)


# ------------------------------------------------- the replicated store
def _pair(shards=1, replicas=4, policy="round_robin", feed="log", fanout=2,
          depth=0, **geometry):
    geometry = dict(SMALL, **geometry)
    bounds = uniform_int_boundaries(KEYSPACE, shards) if shards > 1 else None
    j = JSharded(JConfig(**geometry), heap_capacity=256, shards=shards,
                 boundaries=bounds,
                 replication=JReplication(replicas, policy, feed,
                                          JTopology(fanout, depth)))
    t = TSharded(TConfig(**geometry), heap_capacity=256, shards=shards,
                 boundaries=bounds,
                 replication=TReplication(replicas, policy, feed,
                                          TTopology(fanout, depth)),
                 device="cpu")
    return j, t


def _both(stores, op, *args, **kw):
    j, t = stores
    return getattr(j, op)(*args, **kw), getattr(t, op)(*args, **kw)


def _random_writes(stores, rng, n):
    for _ in range(n):
        k = int_key(int(rng.integers(0, KEYSPACE)))
        roll = rng.random()
        if roll < 0.4:
            _both(stores, "put", k, rng.bytes(int(rng.integers(0, 13))))
        elif roll < 0.85:
            _both(stores, "update", k, rng.bytes(8))
        else:
            _both(stores, "delete", k)


def _image(x) -> np.ndarray:
    """A snapshot image as u32 numpy, from either package."""
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).view(np.uint32)


def _assert_replication_equal(j, t):
    assert dataclasses.asdict(t.feed_stats) == dataclasses.asdict(j.feed_stats)
    assert t.replica_lag_epochs == j.replica_lag_epochs
    assert t.replica_staleness == j.replica_staleness
    assert t.lagging_skips == j.lagging_skips
    assert t.per_shard_replica_ops == j.per_shard_replica_ops
    assert t.replica_load_imbalance == j.replica_load_imbalance
    assert t.replication_bytes == j.replication_bytes
    assert [g.last_dispatch for g in t.shards] \
        == [g.last_dispatch for g in j.shards]
    for jg, tg in zip(j.shards, t.shards):
        assert [dataclasses.asdict(s) for s in tg.per_replica_sync_stats] \
            == [dataclasses.asdict(s) for s in jg.per_replica_sync_stats]
        assert tg.eligible_replicas() == jg.eligible_replicas()
        for jf, tf in zip(jg.followers, tg.followers):
            assert (tf.epoch, tf.in_sync, tf.snapshot_rv, tf.served_ops) \
                == (jf.epoch, jf.in_sync, jf.snapshot_rv, jf.served_ops)
            assert (tf.snapshot is None) == (jf.snapshot is None)
            if tf.snapshot is not None:
                np.testing.assert_array_equal(_image(tf.snapshot.image),
                                              _image(jf.snapshot.image))
                np.testing.assert_array_equal(
                    _image(tf.snapshot.cache_image),
                    _image(jf.snapshot.cache_image))


def _reads(stores, rng, stamps):
    keys = [int_key(int(i)) for i in rng.integers(0, KEYSPACE + 10, 13)]
    jg, tg = _both(stores, "get_batch", keys)
    assert tg == jg
    stamps.append([g.last_dispatch for g in stores[1].shards])
    assert stamps[-1] == [g.last_dispatch for g in stores[0].shards]
    los = rng.integers(0, KEYSPACE, 7)
    ranges = [(int_key(int(a)), int_key(int(a) + int(w))) for a, w in
              zip(los, rng.choice([0, 6, 60], 7))]
    js, ts = _both(stores, "scan_batch", ranges)
    assert ts == js
    stamps.append([g.last_dispatch for g in stores[1].shards])
    assert stamps[-1] == [g.last_dispatch for g in stores[0].shards]


@pytest.mark.parametrize("feed", ["log", "delta"])
@pytest.mark.parametrize("shards,depth", [(1, 0), (1, 2), (3, 0), (3, 2)])
def test_replicated_store_matches_reference(shards, depth, feed):
    """Random epochs with spread reads, a paused (then resumed) relay, and
    a deterministic tail that forces a merge fallback and then log epochs:
    every answer, stamp, meter and follower image agrees."""
    stores = _pair(shards=shards, depth=depth, feed=feed)
    j, t = stores
    rng = np.random.default_rng(11 + shards + depth)
    stamps = []
    for i in rng.permutation(KEYSPACE)[:150]:
        _both(stores, "put", int_key(int(i)), b"v%d" % i)
    _both(stores, "export_snapshot")
    for epoch in range(7):
        for s in stores:
            if epoch == 2:
                s.shards[0].pause_follower(1)
            elif epoch == 4:
                s.shards[0].resume_follower(1)
        _random_writes(stores, rng, int(rng.choice([2, 5, 12])))
        _both(stores, "export_snapshot")
        _reads(stores, rng, stamps)
        _assert_replication_equal(j, t)
    # overflow one leaf's log (a merge: fallback epoch), then lone appends
    # into the merged leaf, so the log feed provably engages
    for _ in range(5):
        _both(stores, "put", int_key(0), b"t" * 8)
    _both(stores, "export_snapshot")
    for v in (b"u" * 8, b"w" * 8, b""):
        _both(stores, "update", int_key(0), v)
        _both(stores, "export_snapshot")
        _reads(stores, rng, stamps)
    _assert_replication_equal(j, t)
    fs = t.feed_stats
    if feed == "log":
        assert fs.log_feed_epochs > 0 and fs.log_fallback_epochs > 0
        assert sum(s.log_replays for g in t.shards
                   for s in g.per_replica_sync_stats) > 0
    else:
        assert fs.log_feed_epochs == 0 and fs.delta_feed_epochs > 0
    assert fs.full_catchups > 0
    assert any(r for r, _ in sum(stamps, []))      # followers served reads
    for g in t.shards:
        for f in g.followers:
            assert torch.equal(f.snapshot.image, g.primary._snapshot.image)


def test_fallback_triggers_match_reference():
    """Merge, overflow-length value and GC each poison the epoch: both
    packages fall back to the image delta, meter it alike and keep the
    followers bit-identical to the primary."""
    stores = _pair(replicas=2)
    j, t = stores
    g = t.shards[0]
    for i in range(30):
        _both(stores, "put", int_key(i), b"v" * 8)
    _both(stores, "export_snapshot")
    fb = []
    for _ in range(5):                       # log_cap=4: merge mid-epoch
        _both(stores, "update", int_key(5), b"m" * 8)
    _both(stores, "export_snapshot")
    fb.append(g.feed_stats.log_fallback_epochs)
    big = b"x" * (TConfig(**SMALL).max_inline_val_bytes + 8)
    _both(stores, "update", int_key(6), big)
    _both(stores, "export_snapshot")
    fb.append(g.feed_stats.log_fallback_epochs)
    _both(stores, "update", int_key(7), b"g" * 8)
    jn, tn = _both(stores, "collect_garbage")
    assert tn == jn > 0
    _both(stores, "export_snapshot")
    fb.append(g.feed_stats.log_fallback_epochs)
    assert fb == [fb[0], fb[0] + 1, fb[0] + 2] and fb[0] >= 1
    _both(stores, "update", int_key(8), b"l" * 8)    # a log epoch again
    _both(stores, "export_snapshot")
    assert g.feed_stats.log_fallback_epochs == fb[-1]
    _assert_replication_equal(j, t)
    for k, want in ((6, big), (7, b"g" * 8), (8, b"l" * 8)):
        jg, tg = (s.shards[0].get_batch([int_key(k)], replica=1)
                  for s in stores)
        assert tg == jg == [want]
    _assert_replication_equal(j, t)


def test_pause_resume_and_resync_catchups_match_reference():
    stores = _pair(replicas=3)
    j, t = stores
    for i in range(60):
        _both(stores, "put", int_key(i), b"v" * 8)
    _both(stores, "export_snapshot")
    for s in stores:
        s.shards[0].pause_follower(2)
    for e in range(3):
        for i in range(e, 60, 9):
            _both(stores, "update", int_key(i), b"e%d" % e)
        _both(stores, "export_snapshot")
    _assert_replication_equal(j, t)
    assert t.replica_lag_epochs == [[0, 3]]
    for s in stores:
        s.shards[0].resync_follower(2)        # admin catch-up, then serve
    _assert_replication_equal(j, t)
    assert t.replica_lag_epochs == [[0, 0]]
    for s in stores:
        s.shards[0].pause_follower(1)
    _both(stores, "update", int_key(1), b"p")
    _both(stores, "export_snapshot")
    for s in stores:
        s.shards[0].resume_follower(1)
    _both(stores, "update", int_key(2), b"q")
    _both(stores, "export_snapshot")          # full catch-up on this sync
    _assert_replication_equal(j, t)
    fs = t.feed_stats
    assert fs.full_catchups == 2 and fs.catchup_bytes > 0
    for lane in (1, 2):
        jg, tg = (s.shards[0].get_batch([int_key(1), int_key(2)],
                                        replica=lane) for s in stores)
        assert tg == jg == [b"p", b"q"]
    _assert_replication_equal(j, t)


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "primary_only"])
def test_policy_pick_sequences_match_reference(policy):
    """The pick sequence over a run with a lagging follower, and the reads
    each pick serves, agree."""
    stores = _pair(shards=2, replicas=3, policy=policy)
    j, t = stores
    rng = np.random.default_rng(2)
    for i in rng.permutation(KEYSPACE):
        _both(stores, "put", int_key(int(i)), b"v")
    _both(stores, "export_snapshot")
    picks = ([], [])
    for rnd in range(6):
        if rnd == 2:
            for s in stores:
                s.shards[1].pause_follower(2)
        _random_writes(stores, rng, 6)
        _both(stores, "export_snapshot")
        for _ in range(5):
            for s, p in zip(stores, picks):
                p.append([s.replica_for_dispatch(sh) for sh in range(2)])
        _reads(stores, rng, [])
    assert picks[1] == picks[0]
    _assert_replication_equal(j, t)
    if policy == "primary_only":
        assert {r for p in picks[1] for r in p} == {0}
    else:
        assert {r for p in picks[1] for r in p} == {0, 1, 2}


def test_single_replica_is_the_unreplicated_store():
    """replicas=1 is op-for-op the port's unreplicated store: same answers
    and sync bytes, no followers, log capture never set."""
    t = TSharded(TConfig(**SMALL), heap_capacity=256,
                 replication=TReplication(1, "round_robin"), device="cpu")
    u = TStore(TConfig(**SMALL), heap_capacity=256, device="cpu")
    g = t.shards[0]
    assert not g.followers and not g.primary.log_capture
    rng = np.random.default_rng(6)
    for _ in range(3):
        _random_writes((u, t), rng, 50)
        keys = [int_key(i) for i in range(0, KEYSPACE, 7)]
        assert t.get_batch(keys) == u.get_batch(keys)
        ranges = [(int_key(a), int_key(a + 9)) for a in range(0, 180, 31)]
        assert t.scan_batch(ranges) == u.scan_batch(ranges)
        t.export_snapshot()
        u.export_snapshot()
        assert t.sync_stats == u.sync_stats
    assert g.primary._epoch_log == [] and not g.primary.log_capture
    assert t.replication_bytes == 0 and t.lagging_skips == 0
    assert dataclasses.asdict(t.feed_stats) \
        == dataclasses.asdict(type(t.feed_stats)())


def test_late_attached_followers_match_reference():
    """A replica group built over a primary that already serves copies its
    active snapshot at once; both packages meter it alike."""
    from repro.core.replica import ReplicaGroup as JGroup
    from repro.core.shard import StoreShard as JShard
    from repro_torch.core import ReplicaGroup as TGroup
    from repro_torch.core import StoreShard as TShard
    shards = (JShard(JConfig(**SMALL), 256),
              TShard(TConfig(**SMALL), 256, device="cpu"))
    for i in range(50):
        _both(shards, "put", int_key(i), b"v%d" % i)
    _both(shards, "export_snapshot")
    groups = (JGroup(shards[0], JReplication(3, "round_robin")),
              TGroup(shards[1], TReplication(3, "round_robin")))
    for _ in range(2):
        _both(groups, "update", int_key(3), b"w")
        _both(groups, "export_snapshot")
    jg, tg = groups
    assert [dataclasses.asdict(s) for s in tg.per_replica_sync_stats] \
        == [dataclasses.asdict(s) for s in jg.per_replica_sync_stats]
    assert dataclasses.asdict(tg.feed_stats) \
        == dataclasses.asdict(jg.feed_stats)
    for lane in (1, 2):
        assert tg.get_batch([int_key(3)], replica=lane) \
            == jg.get_batch([int_key(3)], replica=lane) == [b"w"]
        assert tg.last_dispatch == jg.last_dispatch
