"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one; run them
on the card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_cuda.py``.  Integer results must be exactly equal.

The card is looked for inside the ``cuda`` fixture, never at import, so
every pytest-xdist worker collects the same tests."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (FeedTopology, HoneycombConfig, HoneycombStore,
                              NodeImageLayout, ReplicationConfig,
                              ShardedHoneycombStore, uniform_int_boundaries)
from repro_torch.core.keys import int_key, pack_keys
from repro_torch.core.read_path import attach_cache_image
from repro_torch.kernels import build, delta_scatter, fused_read, ref

pytestmark = pytest.mark.gpu

SMALL = HoneycombConfig(node_cap=16, log_cap=4, n_shortcuts=4,
                        cache_slots=32, max_scan_leaves=2,
                        max_scan_items=16, max_height=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _store(cfg, n, device, seed=0):
    rng = np.random.default_rng(seed)
    st = HoneycombStore(cfg, heap_capacity=256, device=device)
    for i in rng.permutation(n):
        st.put(int_key(int(i)), b"v%06d" % i)
    for i in range(0, n, 7):
        st.update(int_key(i), b"u%06d" % i)
    for i in range(0, n, 13):
        st.delete(int_key(i))
    return st


def _keys(keys, cfg, device):
    lanes, lens = pack_keys(keys, cfg.key_words)
    return (torch.from_numpy(lanes.view(np.int32)).to(device),
            torch.from_numpy(lens).to(device))


def _assert_equal(want, got):
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f


def _snapshots(st, cfg):
    """The store's snapshot at its own read version and at two older ones
    (which walk MVCC old-version chains), cache tier re-attached."""
    snap = st.export_snapshot()
    rv = snap.read_version
    return [snap] + [attach_cache_image(snap._replace(read_version=v), cfg)
                     for v in (max(rv - 40, 0), max(rv - 400, 0))]


@pytest.mark.parametrize("cfg,n", [(SMALL, 300), (HoneycombConfig(), 3000)])
@pytest.mark.parametrize("lb_fraction", [0.0, 0.25])
def test_fused_get_kernel_matches_plain(cuda, cfg, n, lb_fraction):
    st = _store(cfg, n, cuda)
    keys = [int_key(int(i)) for i in
            np.random.default_rng(1).integers(0, n + 50, 100)]
    key, klen = _keys(keys, cfg, cuda)
    for snap in _snapshots(st, cfg):
        want, wm = ref.batched_get_fused_ref(snap, key, klen, cfg=cfg,
                                             lb_fraction=lb_fraction)
        got, gm = fused_read.batched_get_fused(snap, key, klen, cfg=cfg,
                                               lb_fraction=lb_fraction)
        _assert_equal(want, got)
        assert torch.equal(wm, gm)


@pytest.mark.parametrize("cfg,n", [(SMALL, 300), (HoneycombConfig(), 3000)])
@pytest.mark.parametrize("lb_fraction", [0.0, 0.25])
def test_fused_scan_kernel_matches_plain(cuda, cfg, n, lb_fraction):
    st = _store(cfg, n, cuda)
    rng = np.random.default_rng(2)
    los = rng.integers(0, n + 20, 96)
    widths = rng.choice([0, 3, 8, 40, 200], 96)
    lo, lolen = _keys([int_key(int(x)) for x in los], cfg, cuda)
    hi, hilen = _keys([int_key(int(x + w)) for x, w in zip(los, widths)],
                      cfg, cuda)
    for snap in _snapshots(st, cfg):
        want, wm = ref.batched_scan_fused_ref(snap, lo, lolen, hi, hilen,
                                              cfg=cfg,
                                              lb_fraction=lb_fraction)
        got, gm = fused_read.batched_scan_fused(snap, lo, lolen, hi, hilen,
                                                cfg=cfg,
                                                lb_fraction=lb_fraction)
        _assert_equal(want, got)
        assert torch.equal(wm, gm)
        assert bool(want.truncated.any())  # the slot budget is exercised


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_row_scatter_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    S, W = 300, 1273
    image = torch.randint(-2 ** 31, 2 ** 31 - 1, (S, W), generator=g,
                          dtype=torch.int32)
    rows = torch.randperm(S, generator=g)[:50].to(torch.int32)
    rows = torch.cat([rows, rows[-1:].expand(14)])   # padded repeats
    upd = torch.randint(-2 ** 31, 2 ** 31 - 1, (50, W), generator=g,
                        dtype=torch.int32)
    upd = torch.cat([upd, upd[-1:].expand(14, W)])
    image, upd = image.view(dtype).to(cuda), upd.view(dtype).to(cuda)
    rows = rows.to(cuda)
    want = ref.snapshot_image_scatter_ref(image.clone(), rows, upd)
    got = delta_scatter.snapshot_image_scatter(image.clone(), rows, upd)
    assert torch.equal(want.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("policy", ["on_read", "explicit"])
def test_store_on_cuda_matches_cpu_store(cuda, policy):
    """The same ops through a CUDA store and a CPU store give the same
    answers, sync meters and cache meters; the CUDA store's reads and
    delta syncs go through the kernels."""
    cfg = dataclasses.replace(SMALL, sync_policy=policy, lb_fraction=0.25)
    stores = [_store(cfg, 300, d) for d in (cuda, "cpu")]
    build.reset_launches()
    rng = np.random.default_rng(3)
    for rnd in range(4):
        for s in stores:
            s.export_snapshot()
        for i in rng.integers(0, 320, 40):
            for s in stores:
                s.update(int_key(int(i)), b"r%d-%d" % (rnd, i))
        keys = [int_key(int(i)) for i in rng.integers(0, 320, 33)]
        ranges = [(int_key(int(i)), int_key(int(i) + 9))
                  for i in rng.integers(0, 320, 17)]
        gets = [s.get_batch(keys) for s in stores]
        scans = [s.scan_batch(ranges) for s in stores]
        assert gets[0] == gets[1] and scans[0] == scans[1]
    assert stores[0].sync_stats == stores[1].sync_stats
    assert stores[0].cache_stats == stores[1].cache_stats
    assert build.LAUNCHES["fused_get"] == 4
    assert build.LAUNCHES["fused_scan"] == 4
    assert build.LAUNCHES["row_scatter"] == stores[0].sync_stats.delta_syncs
    assert stores[0].sync_stats.delta_syncs >= 3


@pytest.mark.parametrize("bad", [300, -301])
def test_row_scatter_kernel_rejects_rows_out_of_range(cuda, bad):
    """Like the plain version, the wrapper raises on a row outside
    [-S, S) and writes nothing; -1 wraps to the last row."""
    image = torch.zeros(300, 1273, dtype=torch.int32, device=cuda)
    upd = torch.ones(2, 1273, dtype=torch.int32, device=cuda)
    rows = torch.tensor([5, bad], dtype=torch.int32, device=cuda)
    with pytest.raises(IndexError):
        delta_scatter.snapshot_image_scatter(image, rows, upd)
    assert not bool(image.any())
    rows = torch.tensor([5, -1], dtype=torch.int32, device=cuda)
    want = ref.snapshot_image_scatter_ref(image.clone(), rows, upd)
    got = delta_scatter.snapshot_image_scatter(image, rows, upd)
    assert torch.equal(want, got) and bool(got[299].eq(1).all())


def _replay_case(seed, n_entries, S=300):
    """A random image and log entries at SMALL's geometry: up to three
    entries per row at distinct slots, in shuffled order, padded with
    repeats of the last record; row 7 has an old nlog above every new
    slot."""
    layout = NodeImageLayout.for_config(SMALL)
    offs = layout.log_replay_offsets()
    g = torch.Generator(device="cpu").manual_seed(seed)
    image = torch.randint(-2 ** 31, 2 ** 31 - 1, (S, layout.image_words),
                          generator=g, dtype=torch.int32)
    pool = torch.randperm(S - 8, generator=g)[:(n_entries + 2) // 3] + 8
    pool[0] = 7
    i = torch.arange(n_entries)
    order = torch.randperm(n_entries, generator=g)
    rows = pool[i // 3][order].to(torch.int32)
    slots = (i % 3)[order].to(torch.int32)
    image[7, offs.nlog] = offs.log_cap
    entries = torch.randint(-2 ** 31, 2 ** 31 - 1,
                            (n_entries, layout.log_entry_words), generator=g,
                            dtype=torch.int32)
    pad = 5
    rows = torch.cat([rows, rows[-1:].expand(pad)])
    slots = torch.cat([slots, slots[-1:].expand(pad)])
    entries = torch.cat([entries, entries[-1:].expand(pad, -1)])
    return image, rows, slots, entries, offs


@pytest.mark.parametrize("seed,n_entries", [(0, 3), (1, 27), (2, 200)])
def test_log_replay_kernel_matches_plain(cuda, seed, n_entries):
    image, rows, slots, entries, offs = _replay_case(seed, n_entries)
    want = ref.log_replay_scatter_ref(image.clone(), rows, slots, entries,
                                      offs=offs)
    dev = [x.to(cuda) for x in (image, rows, slots, entries)]
    build.reset_launches()
    got = delta_scatter.log_replay_scatter(*dev, offs=offs)
    torch.cuda.synchronize()
    assert got.data_ptr() == dev[0].data_ptr()          # in place
    assert build.LAUNCHES["log_replay"] == 1
    assert torch.equal(want, got.cpu())
    # row 7's old count (log_cap) gives way to its highest new slot + 1
    assert int(want[7, offs.nlog]) == int(slots[rows == 7].max()) + 1


@pytest.mark.parametrize("row,slot", [(300, 0), (-301, 0), (2, -1), (2, 4)])
def test_log_replay_kernel_rejects_bad_rows_and_slots(cuda, row, slot):
    """Like the plain version, the wrapper raises on a row outside
    [-S, S) or a slot outside [0, log_cap) and writes nothing."""
    image, rows, slots, entries, offs = _replay_case(3, 6)
    rows[1], slots[1] = row, slot
    dev = [x.to(cuda) for x in (image, rows, slots, entries)]
    with pytest.raises(IndexError):
        delta_scatter.log_replay_scatter(*dev, offs=offs)
    assert torch.equal(dev[0].cpu(), image)


@pytest.mark.parametrize("feed", ["log", "delta"])
def test_replicated_store_on_cuda_matches_cpu_store(cuda, feed):
    """A 2-shard, 2-replica store on CUDA answers as on the CPU, with the
    same meters and bit-identical follower images; its follower log
    replays and delta applies go through the kernels."""
    def make(device):
        return ShardedHoneycombStore(
            SMALL, heap_capacity=256, shards=2,
            boundaries=uniform_int_boundaries(320, 2),
            replication=ReplicationConfig(2, "round_robin", feed,
                                          FeedTopology(2, 0)),
            device=device)
    stores = [make(cuda), make("cpu")]
    for i in np.random.default_rng(0).permutation(300):
        for s in stores:
            s.put(int_key(int(i)), b"v%06d" % i)
    build.reset_launches()
    rng = np.random.default_rng(3)
    for rnd in range(8):
        for i in rng.integers(0, 320, int(rng.choice([2, 6, 40]))):
            for s in stores:
                s.update(int_key(int(i)), b"r%d-%d" % (rnd, i))
        for s in stores:
            s.export_snapshot()
        keys = [int_key(int(i)) for i in rng.integers(0, 320, 33)]
        ranges = [(int_key(int(i)), int_key(int(i) + 9))
                  for i in rng.integers(0, 320, 17)]
        gets = [s.get_batch(keys) for s in stores]
        scans = [s.scan_batch(ranges) for s in stores]
        assert gets[0] == gets[1] and scans[0] == scans[1]
    a, b = stores
    assert dataclasses.asdict(a.feed_stats) == dataclasses.asdict(b.feed_stats)
    assert a.per_shard_replica_ops == b.per_shard_replica_ops
    for ga, gb in zip(a.shards, b.shards):
        assert ga.per_replica_sync_stats == gb.per_replica_sync_stats
        for fa, fb in zip(ga.followers, gb.followers):
            assert torch.equal(fa.snapshot.image.cpu(), fb.snapshot.image)
            assert torch.equal(fa.snapshot.image, ga.primary._snapshot.image)
    replays = sum(s.log_replays for g in a.shards
                  for s in g.per_replica_sync_stats)
    applies = sum(s.delta_syncs for g in a.shards
                  for s in g.per_replica_sync_stats)
    assert build.LAUNCHES["log_replay"] == replays
    assert build.LAUNCHES["row_scatter"] == applies
    if feed == "log":
        assert replays > 0 and a.feed_stats.log_feed_epochs > 0
    assert sum(r for g in a.per_shard_replica_ops for r in g[1:]) > 0


def _multi_case(seed, S=300, d=50, pad=14):
    """Fields at the default geometry's widths (1 to 512 words; one held as
    float32), ``d`` distinct dirty rows padded with repeats of the last
    one, two of them negative."""
    layout = NodeImageLayout.for_config(HoneycombConfig())
    g = torch.Generator(device="cpu").manual_seed(seed)
    widths = [s.words for s in layout.slots.values()]
    dsts = [torch.randint(-2 ** 31, 2 ** 31 - 1, (S, w), generator=g,
                          dtype=torch.int32) for w in widths]
    dsts[3] = dsts[3].view(torch.float32)
    rows = torch.randperm(S, generator=g)[:d].to(torch.int32)
    rows[:2] -= S                    # wrap Python-style
    rows = torch.cat([rows, rows[-1:].expand(pad)])
    upd = []
    for t in dsts:
        u = torch.randint(-2 ** 31, 2 ** 31 - 1, (d, t.shape[1]),
                          generator=g, dtype=torch.int32).view(t.dtype)
        upd.append(torch.cat([u, u[-1:].expand(pad, -1)]))
    return dsts, rows, upd


@pytest.mark.parametrize("seed,d", [(0, 1), (1, 50), (2, 300)])
def test_multi_scatter_kernel_matches_plain(cuda, seed, d):
    """All 24 fields of the default geometry in one launch, repeated and
    negative rows included; untouched rows keep their words."""
    dsts, rows, upd = _multi_case(seed, d=d, pad=14 if d < 300 else 0)
    want = ref.snapshot_multi_scatter_ref([t.clone() for t in dsts], rows,
                                          upd)
    dev = [t.to(cuda) for t in dsts]
    build.reset_launches()
    got = delta_scatter.snapshot_multi_scatter(
        dev, rows.to(cuda), [u.to(cuda) for u in upd])
    torch.cuda.synchronize()
    assert build.LAUNCHES["multi_scatter"] == 1
    assert all(a is b for a, b in zip(got, dev))        # in place
    for w, g in zip(want, got):
        assert torch.equal(w.view(torch.int32), g.cpu().view(torch.int32))


@pytest.mark.parametrize("case", ["row_high", "row_low", "d_mismatch",
                                  "dtype_mismatch", "s_mismatch"])
def test_multi_scatter_kernel_rejects_bad_input(cuda, case):
    """Like the plain version, the wrapper raises on a row outside
    [-S, S); it also refuses mismatched D, S or dtypes; nothing is
    written."""
    dsts, rows, upd = _multi_case(3, d=6)
    if case == "row_high":
        rows[2] = 300
    elif case == "row_low":
        rows[2] = -301
    elif case == "d_mismatch":
        upd[5] = upd[5][:-1]
    elif case == "dtype_mismatch":
        upd[0] = upd[0].view(torch.float32)
    else:
        dsts[7] = dsts[7][:-1]
    dev = [t.to(cuda) for t in dsts]
    with pytest.raises(IndexError if case.startswith("row")
                       else ValueError):
        delta_scatter.snapshot_multi_scatter(
            dev, rows.to(cuda), [u.to(cuda) for u in upd])
    for a, b in zip(dev, dsts):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_legacy_service_on_cuda_matches_cpu(cuda, pipeline):
    """A 2-shard, 2-replica legacy store through HoneycombService on CUDA
    answers as on the CPU, with equal meters and followers equal to their
    primaries field by field; every delta, primary or follower, is one
    multi-field scatter launch, and nothing launches a fused read, row
    scatter or log replay."""
    from repro_torch.core import FIELD_NAMES, HoneycombService, Get, Put
    cfg = dataclasses.replace(SMALL, layout="legacy")

    def make(device):
        st = ShardedHoneycombStore(
            cfg, heap_capacity=256, shards=2,
            boundaries=uniform_int_boundaries(320, 2),
            replication=ReplicationConfig(2, "round_robin"), device=device)
        return st, HoneycombService(st, batch_size=16, pipeline=pipeline)
    (a, sa), (b, sb) = make(cuda), make("cpu")
    build.reset_launches()
    rng = np.random.default_rng(4)
    for svc in (sa, sb):
        svc.submit_many(Put(int_key(int(i)), b"v%06d" % i)
                        for i in np.random.default_rng(0).permutation(300))
        svc.drain()
    for rnd in range(6):
        ops = [Put(int_key(int(i)), b"r%d-%d" % (rnd, i))
               for i in rng.integers(0, 320, int(rng.choice([3, 30])))]
        ops += [Get(int_key(int(i))) for i in rng.integers(0, 320, 40)]
        got = [svc.submit_many(ops) for svc in (sa, sb)]
        for svc in (sa, sb):
            svc.drain()
        assert [t.result() for t in got[0]] == [t.result() for t in got[1]]
    assert a.sync_stats == b.sync_stats
    assert dataclasses.asdict(a.feed_stats) == dataclasses.asdict(b.feed_stats)
    for g in a.shards:
        p = g.primary._snapshot
        for f in g.followers:
            for name in FIELD_NAMES + ("pagetable",):
                assert torch.equal(getattr(f.snapshot, name),
                                   getattr(p, name)), name
    applies = sum(s.delta_syncs for g in a.shards
                  for s in g.per_replica_sync_stats)
    assert applies > 0 and build.LAUNCHES["multi_scatter"] == applies
    assert build.LAUNCHES["fused_get"] == build.LAUNCHES["fused_scan"] \
        == build.LAUNCHES["row_scatter"] == build.LAUNCHES["log_replay"] == 0
