"""The port's legacy per-field snapshot layout against the reference.

A ``repro_torch`` store on the CPU (plain versions) and a ``repro.core``
store (XLA:CPU, jnp oracles) in ``layout="legacy"`` take the same seeded
writes: every field of every snapshot (primaries and followers, after the
full publish and after each delta), ``SyncStats`` (``image_dma_count``
included: 24 copies per dirty node), ``FeedStats`` and the answers must be
exactly equal.  Within the port, a packed store and a legacy store give
the same answers and stamps and the same sync accounting but for the copy
count.  The plain multi-field scatter equals the reference's oracle and
its interpret-mode Pallas kernel, and refuses a bad row before writing."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HoneycombConfig as JConfig
from repro.core import HoneycombStore as JStore
from repro.core import ReplicationConfig as JReplication
from repro.core import ShardedHoneycombStore as JSharded
from repro.core import uniform_int_boundaries
from repro.kernels import ops as jops
from repro_torch.core import FIELD_NAMES, HoneycombService
from repro_torch.core import HoneycombConfig as TConfig
from repro_torch.core import HoneycombStore as TStore
from repro_torch.core import LegacySnapshotDelta, LegacyTreeSnapshot
from repro_torch.core import ReplicationConfig as TReplication
from repro_torch.core import ShardedHoneycombStore as TSharded
from repro_torch.core.keys import int_key
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SMALL = dict(node_cap=16, log_cap=4, n_shortcuts=4)
KEYSPACE = 200


def assert_snapshot_equal(j, t):
    """Every field of a reference snapshot equals the port's: tensors bit
    for bit (u32 words as their int32 views), the two sync scalars as
    ints."""
    assert type(t).__name__ == type(j).__name__
    for f in t._fields:
        a, b = getattr(j, f), getattr(t, f)
        if isinstance(b, torch.Tensor):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape), f
            np.testing.assert_array_equal(a.view(np.int32), b.numpy(),
                                          err_msg=f)
        elif b is None:
            assert a is None, f
        else:
            assert int(a) == b, f


def _write_round(stores, rng, n, keyspace=KEYSPACE):
    """The same seeded puts, updates and deletes on every store."""
    for _ in range(n):
        k = int_key(int(rng.integers(0, keyspace)))
        p, v = rng.random(), b"w%04d" % int(rng.integers(0, 10000))
        for st in stores:
            if p < 0.6:
                st.put(k, v)
            elif p < 0.8:
                st.update(k, v)
            else:
                st.delete(k)


# ------------------------------------------------ the store, field by field
@pytest.mark.parametrize("geometry", [SMALL, {}])
def test_legacy_snapshot_matches_reference(geometry):
    """A single legacy shard: the full publish and every delta give the
    reference's snapshot field by field, the staged LegacySnapshotDelta
    equals the reference's, and SyncStats match with 24 copies per node."""
    cap = 256 if geometry else 64
    jst = JStore(JConfig(layout="legacy", **geometry), heap_capacity=cap)
    tst = TStore(TConfig(layout="legacy", **geometry), heap_capacity=cap,
                 device="cpu")
    deltas = 0
    rng = np.random.default_rng(3)
    n = 150 if geometry else 400
    for i in rng.permutation(n):
        for st in (jst, tst):
            st.put(int_key(int(i)), b"v%05d" % i)
    for round_ in range(4):
        assert_snapshot_equal(jst.export_snapshot(), tst.export_snapshot())
        assert isinstance(tst._snapshot, LegacyTreeSnapshot)
        assert dataclasses.asdict(tst.sync_stats) \
            == dataclasses.asdict(jst.sync_stats), round_
        _write_round((jst, tst), rng, 10, n)
        # capture the staged delta of the next sync on both sides
        jst.begin_export()
        tst.begin_export()
        jd, td = jst.last_staged.delta, tst.last_staged.delta
        assert (jd is None) == (td is None)
        if td is not None:      # else a full publish (the heap grew)
            assert isinstance(td, LegacySnapshotDelta)
            assert_snapshot_equal(jd, td)
            deltas += 1
        jst.flip()
        tst.flip()
    s = tst.sync_stats
    assert deltas >= 2 and s.delta_syncs == deltas
    assert s.image_dma_count == len(FIELD_NAMES) * (s.full_syncs
                                                    + s.delta_rows)
    if geometry:        # reads at the small geometry (the cheap compile)
        keys = [int_key(i) for i in range(0, n + 10, 3)]
        assert tst.get_batch(keys) == jst.get_batch(keys)
        ranges = [(int_key(a), int_key(a + 6)) for a in range(0, n, 11)]
        assert tst.scan_batch(ranges) == jst.scan_batch(ranges)


@pytest.mark.parametrize("replicas", [1, 3])
def test_replicated_legacy_store_matches_reference(replicas):
    """Two legacy shards with followers on the delta feed (the log feed
    needs a packed image): primaries and followers equal the reference's
    field by field after every sync, and so do FeedStats, per-replica
    SyncStats and the answers of every replica."""
    cfgs = dict(heap_capacity=256, shards=2,
                boundaries=uniform_int_boundaries(KEYSPACE, 2))
    jst = JSharded(JConfig(layout="legacy", **SMALL),
                   replication=JReplication(replicas, "round_robin"), **cfgs)
    tst = TSharded(TConfig(layout="legacy", **SMALL),
                   replication=TReplication(replicas, "round_robin"),
                   device="cpu", **cfgs)
    rng = np.random.default_rng(9)
    for round_ in range(4):
        _write_round((jst, tst), rng, 50)
        jst.export_snapshot()
        tst.export_snapshot()
        for jg, tg in zip(jst.shards, tst.shards):
            assert not tg._log_enabled
            assert_snapshot_equal(jg.primary._snapshot,
                                  tg.primary._snapshot)
            for jf, tf in zip(jg.followers, tg.followers):
                assert_snapshot_equal(jf.snapshot, tf.snapshot)
            assert [dataclasses.asdict(s) for s in
                    tg.per_replica_sync_stats] \
                == [dataclasses.asdict(s) for s in jg.per_replica_sync_stats]
            assert dataclasses.asdict(tg.feed_stats) \
                == dataclasses.asdict(jg.feed_stats), round_
        keys = [int_key(i) for i in range(0, KEYSPACE, 7)]
        for r in range(replicas):
            assert tst.get_batch(keys, replica=r) \
                == jst.get_batch(keys, replica=r)
    fs = tst.feed_stats
    if replicas > 1:
        assert fs.delta_feed_epochs > 0 and fs.full_feed_epochs > 0
        assert fs.log_feed_epochs == fs.log_fallback_epochs == 0


# --------------------------------------- packed == legacy, within the port
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_packed_equals_legacy_randomized(shards, replicas, pipeline):
    """The port's packed and legacy layouts give the same responses and
    stamps through the service, and the same sync accounting but for
    ``image_dma_count`` (one per dirty node against one per field per
    node), across shards x replicas x pipeline modes (mirrors
    tests/test_layout.py)."""
    bnd = uniform_int_boundaries(KEYSPACE, shards) if shards > 1 else None
    repl = TReplication(replicas, "round_robin" if replicas > 1
                        else "primary_only", feed="delta")
    stores, svcs = [], []
    for layout in ("packed", "legacy"):
        st = TSharded(TConfig(layout=layout, **SMALL), heap_capacity=256,
                      shards=shards, boundaries=bnd, replication=repl,
                      device="cpu")
        stores.append(st)
        svcs.append(HoneycombService(st, batch_size=8, pipeline=pipeline))
    pk, lg = stores
    rng = np.random.default_rng(42)
    from test_torch_service import random_ops
    for round_ in range(3):
        ops = random_ops(rng, 60)
        tickets = [svc.submit_many(ops) for svc in svcs]
        for svc in svcs:
            svc.drain()
        assert [t.result() for t in tickets[0]] \
            == [t.result() for t in tickets[1]], round_
        sp = dataclasses.asdict(pk.sync_stats)
        sl = dataclasses.asdict(lg.sync_stats)
        assert sp.pop("image_dma_count") < sl.pop("image_dma_count")
        assert sp == sl, round_
        assert pk.replication_bytes == lg.replication_bytes, round_
    assert pk.sync_stats.delta_syncs > 0
    assert pk.sync_stats.image_bytes == lg.sync_stats.image_bytes > 0
    if replicas > 1:
        assert pk.replication_bytes > 0


# ------------------------------------------------- the multi-field scatter
def _multi_case(seed, S=32, widths=(12, 1, 7, 512), d=5):
    """Fields of several widths (u32 and i32), ``d`` distinct rows padded
    with a repeat of the last one (identical data), one negative row."""
    rng = np.random.default_rng(seed)
    dsts = [rng.integers(0, 2 ** 32, (S, w), np.int64).astype(
        np.uint32 if i % 2 == 0 else np.int32) for i, w in enumerate(widths)]
    rows = rng.permutation(S)[:d].astype(np.int32)
    rows[1] -= S                      # wraps to the same row, Python-style
    rows = np.concatenate([rows, rows[-1:]])
    upd = []
    for a in dsts:
        u = rng.integers(0, 2 ** 32, (d, a.shape[1]), np.int64).astype(
            a.dtype)
        upd.append(np.concatenate([u, u[-1:]]))
    return dsts, rows, upd


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_scatter_plain_matches_reference(seed):
    """The plain multi-field scatter equals the reference's jnp oracle and
    its interpret-mode Pallas kernel, duplicate and negative rows
    included, in place and through ``ops`` on the CPU."""
    dsts, rows, upd = _multi_case(seed)
    jd = [jnp.asarray(a) for a in dsts]
    ju = [jnp.asarray(u) for u in upd]
    want = jops.snapshot_multi_scatter(jd, jnp.asarray(rows), ju,
                                       backend="ref")
    interp = jops.snapshot_multi_scatter(jd, jnp.asarray(rows), ju,
                                         backend="interpret")
    td = [torch.from_numpy(a.view(np.int32).copy()) for a in dsts]
    tu = [torch.from_numpy(u.view(np.int32).copy()) for u in upd]
    got = tref.snapshot_multi_scatter_ref(td, torch.from_numpy(rows), tu)
    assert all(g is t for g, t in zip(got, td))     # in place
    via_ops = tops.snapshot_multi_scatter(
        [torch.from_numpy(a.view(np.int32).copy()) for a in dsts],
        torch.from_numpy(rows), tu)
    for w, i, g, o in zip(want, interp, got, via_ops):
        np.testing.assert_array_equal(np.asarray(w).view(np.int32),
                                      g.numpy())
        np.testing.assert_array_equal(np.asarray(i).view(np.int32),
                                      g.numpy())
        assert torch.equal(g, o)


@pytest.mark.parametrize("bad", [32, -33])
def test_multi_scatter_plain_rejects_bad_rows(bad):
    """A row outside [-S, S) raises IndexError before any field is
    written."""
    dsts, rows, upd = _multi_case(2)
    rows[2] = bad
    td = [torch.from_numpy(a.view(np.int32).copy()) for a in dsts]
    before = [t.clone() for t in td]
    tu = [torch.from_numpy(u.view(np.int32).copy()) for u in upd]
    with pytest.raises(IndexError):
        tref.snapshot_multi_scatter_ref(td, torch.from_numpy(rows), tu)
    assert all(torch.equal(a, b) for a, b in zip(td, before))
