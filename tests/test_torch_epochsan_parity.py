"""EpochSan on the port's seams against EpochSan on the reference's.

The same seeded op sequences run through a ``repro.core`` store under
``repro.analysis.epochsan.enabled()`` and through a ``repro_torch.core``
store on the CPU under ``repro_torch.analysis.epochsan.enabled()``, both
in recording mode (``strict=False``) so that every sequence runs to its
end.  The violation kinds, in order, and every ``EpochSanStats`` field
must be equal (kinds and counters, not message text).  The sequences:
the clean lifecycle, a standby read, pinned-epoch GC (``_reclaimable``
monkeypatched under ``sync_policy="explicit"``), follower freshness
(``_covers`` monkeypatched), stale cache rows after a remap, a remap
then a refresh, an unflipped export, a 2-shard x 2-replica log-feed run
of update, insert and GC epochs, and a service drain.  A last test runs
the port's store, replicated and service sequences in strict mode with
no violation, since the tier-1 run does not set ``HONEYCOMB_EPOCHSAN``.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

import repro.core as J
from repro.analysis import epochsan as jsan
from repro.core import gc as jgc
from repro.core import replica as jreplica
from repro.core import uniform_int_boundaries
import repro_torch.core as T
from repro_torch.analysis import epochsan as tsan
from repro_torch.core import gc as tgc
from repro_torch.core import replica as treplica
from repro_torch.core.keys import int_key

SMALL = dict(node_cap=16, log_cap=4, n_shortcuts=4)
KEYSPACE = 200

JP = types.SimpleNamespace(core=J, san=jsan, gc=jgc, replica=jreplica,
                           dev={})
TP = types.SimpleNamespace(core=T, san=tsan, gc=tgc, replica=treplica,
                           dev={"device": "cpu"})


def _key(i: int) -> bytes:
    return f"k{i:03d}".encode()


def _shard(P, n=20, **cfg):
    s = P.core.StoreShard(P.core.HoneycombConfig(**cfg), **P.dev)
    for i in range(n):
        s.put(_key(i), b"v" * 8)
    s.export_snapshot()
    return s


# ------------------------------------------------------------ sequences
def seq_clean(P, mp):
    s = _shard(P)
    out = [s.get_batch([_key(1)]), s.scan_batch([(_key(1), _key(4))])]
    for i in range(20):
        s.put(_key(i), b"w" * 8)
    s.begin_export()
    s.flip()
    out.append(s.collect_garbage())
    out.append(s.get_batch([_key(1), _key(30)]))
    return out


def seq_standby_read(P, mp):
    s = _shard(P)
    s.put(_key(0), b"x" * 8)
    s.begin_export()                    # staged, not flipped
    out = [s._device_get(s._standby, [_key(0)]),
           s._device_scan(s._standby, [(_key(0), _key(2))], None)]
    s.flip()
    out.append(s.get_batch([_key(0)]))
    return out


def seq_pinned_gc(P, mp):
    s = _shard(P, n=40, sync_policy="explicit")
    for i in range(40):
        s.update(_key(i), b"w" * 8)
    assert s.tree.gc.list
    mp.setattr(P.gc.GarbageCollector, "_reclaimable", lambda self, e: True)
    return [s.collect_garbage()]


def seq_follower_freshness(P, mp):
    g = P.replica.ReplicaGroup(P.core.StoreShard(**P.dev),
                               P.core.ReplicationConfig(replicas=2))
    for i in range(20):
        g.put(_key(i), b"v" * 8)
    g.export_snapshot()
    out = [g.get_batch([_key(1)], replica=1),
           g.scan_batch([(_key(1), _key(3))], replica=1)]
    g.pause_follower(1)
    for i in range(20):
        g.put(_key(i), b"w" * 8)
    g.export_snapshot()
    g.resume_follower(1)
    mp.setattr(P.replica.ReplicaGroup, "_covers", lambda self, f: True)
    out.append(g.get_batch([_key(1)], replica=1))
    out.append(g.scan_batch([(_key(1), _key(2))], replica=1))
    return out


def seq_stale_cache(P, mp):
    s = _shard(P)
    s.put(_key(0), b"w" * 8)
    s.tree.pt.remap(0, s.tree.pt.lookup(0))     # remap hits the cache
    s.cache.refresh = lambda tree: None         # "forgot to refresh"
    s.begin_export()
    s.flip()
    return [s.get_batch([_key(0)])]


def seq_remap_refresh(P, mp):
    s = _shard(P)
    s.put(_key(0), b"w" * 8)
    s.tree.pt.remap(0, s.tree.pt.lookup(0))
    s.export_snapshot()                         # refreshes the cache itself
    return [s.get_batch([_key(0)])]


def seq_unflipped_export(P, mp):
    s = P.core.StoreShard(**P.dev)
    for i in range(10):
        s.put(_key(i), b"v" * 8)
    sched = P.core.OutOfOrderScheduler(pipeline="pipelined")
    s.flip = lambda: None                       # "forgot to publish"
    sched.stage_export(s)
    return [s._standby is not None]


def _sharded(P, layout="packed", feed="log"):
    return P.core.ShardedHoneycombStore(
        P.core.HoneycombConfig(layout=layout, **SMALL), heap_capacity=256,
        shards=2, boundaries=uniform_int_boundaries(KEYSPACE, 2),
        replication=P.core.ReplicationConfig(2, "round_robin", feed=feed),
        **P.dev)


def seq_log_feed(P, mp):
    """Update, insert and GC epochs on a 2-shard x 2-replica log feed,
    reads spread over both replicas after each."""
    st = _sharded(P)
    rng = np.random.default_rng(5)
    for i in rng.permutation(KEYSPACE)[:150]:
        st.put(int_key(int(i)), b"v%03d" % i)
    st.export_snapshot()
    out = []
    for e in range(6):
        if e % 3 == 0:                      # update epoch
            for i in rng.integers(0, KEYSPACE, 6):
                st.put(int_key(int(i)), b"u%03d" % e)
        elif e % 3 == 1:                    # insert epoch
            for i in rng.integers(0, KEYSPACE, 12):
                st.put(int_key(int(i)) + b"\x01", b"i%03d" % e)
        else:                               # GC epoch
            for i in rng.integers(0, KEYSPACE, 6):
                st.update(int_key(int(i)), b"g%03d" % e)
            out.append([g.collect_garbage() for g in st.shards])
        st.export_snapshot()
        keys = [int_key(int(i)) for i in rng.integers(0, KEYSPACE, 16)]
        for r in (0, 1):
            out.append(st.get_batch(keys, replica=r))
            out.append(st.scan_batch(
                [(int_key(10), int_key(14)), (int_key(95), int_key(105))],
                replica=r))
    out.append(dataclasses.astuple(st.feed_stats))
    return out


def seq_service(P, mp):
    """A pipelined service over a 2-shard x 2-replica legacy store."""
    st = _sharded(P, layout="legacy", feed="delta")
    svc = P.core.HoneycombService(st, batch_size=8, pipeline="pipelined")
    rng = np.random.default_rng(21)
    out = []
    for _ in range(3):
        tickets = []
        for _ in range(60):
            k = int(rng.integers(0, KEYSPACE))
            p = rng.random()
            if p < 0.3:
                op = P.core.Put(int_key(k), b"v%03d" % k)
            elif p < 0.4:
                op = P.core.Delete(int_key(k))
            elif p < 0.8:
                op = P.core.Get(int_key(k))
            else:
                op = P.core.Scan(int_key(k), int_key(min(k + 5, KEYSPACE - 1)),
                                 expected_items=8)
            tickets.append(svc.submit(op))
        svc.drain()
        out.extend(dataclasses.astuple(t.result()) for t in tickets)
    return out


SEQUENCES = {
    "clean": (seq_clean, []),
    "standby_read": (seq_standby_read, ["standby-read", "standby-read"]),
    "pinned_gc": (seq_pinned_gc, None),
    "follower_freshness": (seq_follower_freshness,
                           ["follower-freshness", "follower-freshness"]),
    "stale_cache": (seq_stale_cache, ["stale-cache-rows"]),
    "remap_refresh": (seq_remap_refresh, []),
    "unflipped_export": (seq_unflipped_export,
                         ["unflipped-standby-after-export"]),
    "log_feed": (seq_log_feed, []),
    "service": (seq_service, []),
}


def _run(P, seq, monkeypatch):
    with monkeypatch.context() as mp:
        with P.san.enabled(strict=False) as san:
            out = seq(P, mp)
    return out, [v.kind for v in san.violations], \
        dataclasses.asdict(san.stats)


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_epochsan_matches_reference(name, monkeypatch):
    seq, kinds = SEQUENCES[name]
    jout, jkinds, jstats = _run(JP, seq, monkeypatch)
    tout, tkinds, tstats = _run(TP, seq, monkeypatch)
    assert tkinds == jkinds
    assert tstats == jstats
    assert tout == jout
    if kinds is None:       # pinned GC: one violation per wrongly freed entry
        assert tkinds and set(tkinds) == {"pinned-epoch-gc"}
    else:
        assert tkinds == kinds
    assert tstats["violations"] == len(tkinds)
    if name in ("clean", "log_feed"):
        assert tstats["read_checks"] > 0 and tstats["stagings"] > 0
        assert tstats["flips"] > 0 and tstats["gc_audits"] > 0
    if name == "log_feed":
        assert tstats["dispatch_checks"] > 0


@pytest.mark.parametrize("name", ["clean", "log_feed", "service"])
def test_port_sequences_run_clean_in_strict_mode(name, monkeypatch):
    """The store, replicated and service sequences of the port under the
    strict sanitizer: no violation raised, every seam they pass counted."""
    seq, _ = SEQUENCES[name]
    with monkeypatch.context() as mp, tsan.enabled() as san:
        seq(TP, mp)
    assert san.violations == [] and san.stats.violations == 0
    assert san.stats.read_checks > 0 and san.stats.stagings > 0
    assert san.stats.flips > 0
    if name != "service":
        assert san.stats.gc_audits > 0
    if name != "clean":
        assert san.stats.dispatch_checks > 0
