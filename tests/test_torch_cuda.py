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
from repro_torch.core.heap import LEAF, LOG_UPDATE
from repro_torch.core.keys import int_key, pack_keys
from repro_torch.core.read_path import attach_cache_image
from repro_torch.kernels import (build, delta_scatter, fused_read,
                                 key_search, leaf_merge, paged_attention,
                                 ref)

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


@pytest.mark.parametrize("cache_levels", [1, 3])
def test_fused_read_kernel_three_level_tree(cuda, cache_levels):
    """The default geometry at 2**14 keys (a three-level tree) with one and
    three cached levels; batches of 101 GETs and 77 SCANs, neither a
    multiple of the kernel's warps per block: the results and meters, the
    rows the kernel marks read (``touched``) and each request's dependent
    row reads (``loads``) equal the plain walk's."""
    cfg = dataclasses.replace(HoneycombConfig(), cache_levels=cache_levels)
    n = 1 << 14
    st = _store(cfg, n, cuda)
    assert st.tree.height >= 3
    rng = np.random.default_rng(3)
    key, klen = _keys([int_key(int(i)) for i in
                       rng.integers(0, n + 500, 101)], cfg, cuda)
    los = rng.integers(0, n + 20, 77)
    widths = rng.choice([0, 3, 8, 40, 200], 77)
    lo, lolen = _keys([int_key(int(x)) for x in los], cfg, cuda)
    hi, hilen = _keys([int_key(int(x + w)) for x, w in zip(los, widths)],
                      cfg, cuda)
    for snap in _snapshots(st, cfg):
        for lb_fraction in (0.0, 0.25):
            kw = dict(cfg=cfg, lb_fraction=lb_fraction)
            build.reset_launches()
            for fn, kfn, x in (
                    (ref.batched_get_fused_ref, fused_read.batched_get_fused,
                     (key, klen)),
                    (ref.batched_scan_fused_ref,
                     fused_read.batched_scan_fused, (lo, lolen, hi, hilen))):
                marks = [_row_marks(snap, x[0]) for _ in range(2)]
                want, wm = fn(snap, *x, **kw, touched=marks[0][0],
                              loads=marks[0][1])
                got, gm = kfn(snap, *x, **kw, touched=marks[1][0],
                              loads=marks[1][1])
                _assert_equal(want, got)
                assert torch.equal(wm, gm)
                assert torch.equal(marks[0][0], marks[1][0])
                assert torch.equal(marks[0][1], marks[1][1])
                assert int(marks[1][1].min()) >= st.tree.height
            assert build.LAUNCHES["fused_get"] == 1
            assert build.LAUNCHES["fused_scan"] == 1


def _row_marks(snap, batch):
    """Zeroed ``touched`` [S + C] and ``loads`` [B] for a fused read."""
    n = snap.image.shape[0] + snap.cache_image.shape[0]
    return (torch.zeros(n, dtype=torch.int32, device=batch.device),
            torch.zeros(batch.shape[0], dtype=torch.int32,
                        device=batch.device))


def _corrupt_leaves(snap, cfg, seed):
    """The snapshot with random nitems, nlog, log back pointers and order
    hints in every leaf row: counts below zero and past their blocks,
    hints anywhere, and back pointers drawn from small ones, the whole
    int32 range and those whose ranks backptr * (L + 1) + pos come near
    2**31.  Every fourth leaf instead holds one older log entry of its
    last sorted item's key ranked exactly INT32_MAX, which the stable
    argsort places after the unused sorted slots: not in the item's run
    of equal keys."""
    rng = np.random.default_rng(seed)
    off = NodeImageLayout.for_config(cfg).slots
    N, L = cfg.node_cap, cfg.log_cap
    img = snap.image.clone()
    leaves = torch.nonzero(img[:, off["ntype"].offset] == LEAF)[:, 0]
    n = leaves.shape[0]

    def put(field, vals):
        o = off[field].offset
        w = vals.shape[1] if vals.ndim == 2 else 1
        img[leaves[:, None], o + torch.arange(w, device=img.device)] = \
            torch.from_numpy(vals.reshape(n, w).astype(np.int32)).to(
                img.device)

    put("nitems", rng.integers(-3, N + 4, n))
    put("nlog", rng.integers(-3, L + 4, n))
    wrap_at = (2 ** 31 - 1) // (L + 1)       # backptr * (L + 1) near 2**31
    u = rng.random((n, L))
    bp = np.select([u < 0.4, u < 0.7],
                   [rng.integers(-2, N + 3, (n, L)),
                    rng.integers(-2 ** 31, 2 ** 31, (n, L))],
                   wrap_at + rng.integers(-1, 2, (n, L)))
    put("log_backptr", bp)
    put("log_hint", rng.integers(-2, L + 3, (n, L)))
    # the exact tie: nlog 1, nitems in [1, N), entry 0 = sorted item
    # nitems - 1's key, one version older, rank INT32_MAX
    tie = leaves[::4]
    nit = img[tie, off["nitems"].offset].clamp(1, N - 1)
    img[tie, off["nitems"].offset] = nit
    img[tie, off["nlog"].offset] = 1
    KW = cfg.key_words
    ar = torch.arange(KW, device=img.device)
    src = off["skeys"].offset + (nit - 1)[:, None] * KW + ar
    img[tie[:, None], off["log_keys"].offset + ar] = img[tie[:, None], src]
    img[tie, off["log_keylen"].offset] = \
        img[tie, off["skeylen"].offset + nit - 1]
    img[tie, off["log_backptr"].offset] = wrap_at
    img[tie, off["log_hint"].offset] = (2 ** 31 - 1) - wrap_at * (L + 1)
    img[tie, off["log_vdelta"].offset] = -1
    img[tie, off["log_op"].offset] = LOG_UPDATE
    return attach_cache_image(snap._replace(image=img), cfg)


@pytest.mark.parametrize("cfg,n", [(SMALL, 300), (HoneycombConfig(), 3000)])
def test_fused_read_kernel_on_corrupt_leaves(cuda, cfg, n):
    """Leaves with random count, back-pointer and hint words (ranks that
    wrap in int32 included) read as the plain version reads them: GET and
    SCAN results and meters bit for bit, so the kernel's merge order is
    the stable argsort of the ranks on any input."""
    st = _store(cfg, n, cuda)
    rng = np.random.default_rng(5)
    key, klen = _keys([int_key(int(i)) for i in
                       rng.integers(0, n + 50, 100)], cfg, cuda)
    los = rng.integers(0, n + 20, 96)
    widths = rng.choice([0, 3, 8, 40, 200], 96)
    lo, lolen = _keys([int_key(int(x)) for x in los], cfg, cuda)
    hi, hilen = _keys([int_key(int(x + w)) for x, w in zip(los, widths)],
                      cfg, cuda)
    for seed, snap in enumerate(_snapshots(st, cfg)):
        snap = _corrupt_leaves(snap, cfg, seed)
        for lb_fraction in (0.0, 0.25):
            kw = dict(cfg=cfg, lb_fraction=lb_fraction)
            want, wm = ref.batched_get_fused_ref(snap, key, klen, **kw)
            got, gm = fused_read.batched_get_fused(snap, key, klen, **kw)
            _assert_equal(want, got)
            assert torch.equal(wm, gm)
            want, wm = ref.batched_scan_fused_ref(snap, lo, lolen, hi, hilen,
                                                  **kw)
            got, gm = fused_read.batched_scan_fused(snap, lo, lolen, hi,
                                                    hilen, **kw)
            _assert_equal(want, got)
            assert torch.equal(wm, gm)


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


def _replay_case(seed, n_entries, S=300, pad=5):
    """A random image and log entries at SMALL's geometry: up to three
    entries per row at distinct slots, in shuffled order, padded with
    ``pad`` repeats of the last record; row 7 has an old nlog above every
    new slot."""
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


@pytest.mark.parametrize("D", [1, 4, 1024, 4096])
def test_log_replay_kernel_at_epoch_sizes(cuda, D):
    """D entries as the feed pads them (distinct records, then repeats of
    the last, up to a power of two), one block at small D and many blocks
    walking every pair in several chunks at large D: one launch, equal to
    the plain version."""
    d = {1: 1, 4: 3}.get(D, D - D // 32)
    image, rows, slots, entries, offs = _replay_case(D, d, S=max(300, D),
                                                     pad=D - d)
    assert rows.numel() == D
    want = ref.log_replay_scatter_ref(image.clone(), rows, slots, entries,
                                      offs=offs)
    dev = [x.to(cuda) for x in (image, rows, slots, entries)]
    build.reset_launches()
    got = delta_scatter.log_replay_scatter(*dev, offs=offs)
    assert build.LAUNCHES["log_replay"] == 1
    assert torch.equal(want, got.cpu())


@pytest.mark.parametrize("row,slot", [(300, 0), (-301, 0), (2, -1), (2, 4),
                                      (300, 4)])
def test_log_replay_kernel_rejects_bad_pairs_held_in_registers(cuda, row,
                                                                slot):
    """Up to D = 8 every block holds all the pairs in registers and takes
    one entry: a row outside [-S, S) or a slot outside [0, log_cap)
    raises (rows first) and writes nothing."""
    image, rows, slots, entries, offs = _replay_case(3, 3, pad=1)
    rows[1], slots[1] = row, slot
    dev = [x.to(cuda) for x in (image, rows, slots, entries)]
    with pytest.raises(IndexError, match="rows" if row == 300 or row < -300
                       else "slots"):
        delta_scatter.log_replay_scatter(*dev, offs=offs)
    assert torch.equal(dev[0].cpu(), image)


def test_log_replay_kernel_good_call_after_a_rejected_one(cuda):
    """A bad row in a late block of a many-block call raises and writes
    nothing; the same call with the row repaired, right after, equals the
    plain version (the flag is written anew on every call)."""
    image, rows, slots, entries, offs = _replay_case(4, 1000, S=1200)
    bad = rows.clone()
    bad[900] = 5000
    img, good, slots_d, entries_d = (x.clone().to(cuda) for x in
                                     (image, rows, slots, entries))
    with pytest.raises(IndexError, match="rows must lie"):
        delta_scatter.log_replay_scatter(img, bad.to(cuda), slots_d,
                                         entries_d, offs=offs)
    assert torch.equal(img.cpu(), image)
    want = ref.log_replay_scatter_ref(image.clone(), rows, slots, entries,
                                      offs=offs)
    got = delta_scatter.log_replay_scatter(img, good, slots_d, entries_d,
                                           offs=offs)
    assert torch.equal(want, got.cpu())


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
                                  "dtype_mismatch", "s_mismatch", "bf16"])
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
    elif case == "bf16":             # 2-byte elements: not the kernel's words
        dsts[5], upd[5] = (t.view(torch.bfloat16) for t in (dsts[5], upd[5]))
    else:
        dsts[7] = dsts[7][:-1]
    dev = [t.to(cuda) for t in dsts]
    with pytest.raises(IndexError if case.startswith("row")
                       else ValueError):
        delta_scatter.snapshot_multi_scatter(
            dev, rows.to(cuda), [u.to(cuda) for u in upd])
    for a, b in zip(dev, dsts):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


# fields of the flattened row copy (csrc/scatter_rows.cuh): the legacy
# layout, the packed image, and the plan's edges
SCATTER_WIDTHS = {
    "legacy": tuple(sl.words for sl in NodeImageLayout.for_config(
        HoneycombConfig()).slots.values()),
    "packed": (1273,),
    "ragged": (1000,),        # not a whole number of the block's threads
    "wide": (5000,),          # more than K * threads words: three chunks
    "narrow": (3, 4),         # narrower than a warp
    "fields32": (1, 0, 5, 33, 2, 1, 64, 7, 1, 1, 16, 3, 0, 8, 9, 1,
                 40, 1, 2, 12, 1, 6, 1, 20, 1, 4, 1, 2, 50, 1, 3, 11),
}
# the delta's row lists: pad repeats at the end, a run of repeats inside,
# repeats that are not neighbours, negative rows (pad repeats alternating
# a row's two spellings), one row
SCATTER_ROWS = ("suffix", "interior", "scattered", "negative", "single")


def _flat_case(widths, kind, seed=0, S=64, d=24):
    """numpy inputs of one delta over fields of these widths: [S, W_f]
    int32 destinations, [D] int32 rows and [D, W_f] int32 updates, the
    rows of ``kind`` (``SCATTER_ROWS``); a repeated row repeats its
    data."""
    rng = np.random.default_rng(seed)
    d = 1 if kind == "single" else d
    distinct = rng.permutation(S)[:d].astype(np.int32)
    idx = list(range(d))
    if kind == "suffix":
        idx += [d - 1] * 8
    elif kind == "interior":
        idx = idx[:11] + [10] * 5 + idx[11:]
    elif kind == "scattered":
        idx.insert(7, 3)
        idx.insert(15, 3)
    elif kind == "negative":
        distinct[::3] -= S
        idx += [d - 1] * 4
    idx = np.asarray(idx)
    rows = distinct[idx]
    if kind == "negative":                # the last row, both spellings
        last = int(distinct[-1]) % S
        rows[d:] = [last - S * (n % 2) for n in range(len(idx) - d)]
    i32 = np.iinfo(np.int32)
    dsts = [rng.integers(i32.min, i32.max, (S, w), dtype=np.int32,
                         endpoint=True) for w in widths]
    upd = [rng.integers(i32.min, i32.max, (d, w), dtype=np.int32,
                        endpoint=True)[idx] for w in widths]
    return dsts, rows.astype(np.int32), upd


@pytest.mark.parametrize("kind", SCATTER_ROWS)
@pytest.mark.parametrize("shape", sorted(SCATTER_WIDTHS))
def test_flat_scatter_kernels_at_plan_edges(cuda, shape, kind):
    """Both scatters over the flattened row at the plan's edges equal their
    plain versions on the card, one launch a call: the multi-field kernel
    over the fields, the row scatter over the same fields as one packed
    row."""
    widths = SCATTER_WIDTHS[shape]
    dsts, rows, upd = _flat_case(widths, kind)
    rows_d = torch.from_numpy(rows).to(cuda)
    fields = [torch.from_numpy(a).to(cuda) for a in dsts]
    blocks = [torch.from_numpy(a).to(cuda) for a in upd]
    want = ref.snapshot_multi_scatter_ref([t.clone() for t in fields],
                                          rows_d, blocks)
    build.reset_launches()
    got = delta_scatter.snapshot_multi_scatter(fields, rows_d, blocks)
    torch.cuda.synchronize()
    assert build.LAUNCHES["multi_scatter"] == 1
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    image = torch.from_numpy(np.concatenate(dsts, axis=1)).to(cuda)
    packed = torch.from_numpy(np.concatenate(upd, axis=1)).to(cuda)
    want = ref.snapshot_image_scatter_ref(image.clone(), rows_d, packed)
    got = delta_scatter.snapshot_image_scatter(image, rows_d, packed)
    torch.cuda.synchronize()
    assert build.LAUNCHES["row_scatter"] == 1
    assert torch.equal(want, got)


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


def _i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _search_case(B, N, KW, seed, lane_hi=60):
    """The reference sweep's floor-search inputs (tests/test_kernels.py);
    with ``lane_hi = 2**32`` lanes span the whole u32 range, and half the
    candidates copy their query's lanes up to a random lane so that the
    first difference falls anywhere, high bits included."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, lane_hi, (B, N, KW), dtype=np.uint64) \
        .astype(np.uint32)
    klens = rng.integers(0, KW * 4 + 1, (B, N)).astype(np.int32)
    valid = (rng.random((B, N)) < 0.8).astype(np.int32)
    q = rng.integers(0, lane_hi, (B, KW), dtype=np.uint64).astype(np.uint32)
    qlen = rng.integers(1, KW * 4 + 1, (B,)).astype(np.int32)
    if lane_hi > 2 ** 31:
        cut = rng.integers(0, KW + 1, (B, N))
        share = (np.arange(KW)[None, None, :] < cut[:, :, None]) \
            & (rng.random((B, N, 1)) < 0.5)
        keys = np.where(share, q[:, None, :], keys)
    return q, qlen, keys, klens, valid


#: a node's two candidate blocks: (keys, lengths, count) fields and the
#: config attribute that gives their number of keys
IMAGE_BLOCKS = {"sorted": ("skeys", "skeylen", "nitems", "node_cap"),
                "shortcut": ("sc_keys", "sc_keylen", "n_shortcuts",
                             "n_shortcuts")}


def _image_case(cfg, B, seed, count_top_bit=False, block="sorted"):
    """Random image rows with planted sorted candidate blocks (the sorted
    block, or the shortcut block), as
    tests/test_layout.py:test_key_search_image_kernel_matches_ref plants
    them; with ``count_top_bit`` half the rows' live counts have their top
    bit set (a negative int32).  Returns (q, qlen, img, the block's
    ``key_search_image`` keywords)."""
    layout = NodeImageLayout.for_config(cfg)
    offs = layout.offsets()
    rng = np.random.default_rng(seed)
    kw = cfg.key_words
    keys_f, lens_f, count_f, cap = IMAGE_BLOCKS[block]
    n = getattr(cfg, cap)
    img = rng.integers(0, 2 ** 32, (B, layout.image_words), np.int64) \
        .astype(np.uint32)
    sk, kl, ct = offs[keys_f][0], offs[lens_f][0], offs[count_f][0]
    for b in range(B):
        keys = sorted(rng.integers(65, 91, 6, dtype=np.uint8).tobytes()
                      for _ in range(n))
        lanes, lens = pack_keys(keys, kw)
        img[b, sk:sk + n * kw] = lanes.reshape(-1)
        img[b, kl:kl + n] = lens.astype(np.uint32)
        img[b, ct] = rng.integers(1, n + 1)
        if count_top_bit and b % 2:
            img[b, ct] |= np.uint32(2 ** 31)
    q, qlen = pack_keys([rng.integers(65, 91, 6, dtype=np.uint8).tobytes()
                         for _ in range(B)], kw)
    kwargs = dict(keys_off=sk, lens_off=kl, count_off=ct, n_keys=n,
                  key_words=kw)
    return q, qlen, img, kwargs


#: (n_keys, key_words) of ``_wild_image_case``: the stores' width with a
#: block that needs two chunks, and other widths (the kernel's generic
#: instance), one of them chunked
WILD_IMAGE = [(300, 8), (64, 8), (40, 3), (700, 3), (33, 1), (5, 20)]


def _wild_image_case(N, KW, seed, B=12):
    """Synthetic image rows of just the candidate block (count word 2,
    keys from word 5, lengths after them) with lanes over the whole u32
    range, most candidates sharing their query's lanes up to a random
    lane, so that high bits and ties decided by length both occur, and
    counts of 0, above ``N``, with the top bit set, and in between.
    Returns (q, qlen, img, keywords)."""
    rng = np.random.default_rng(seed)
    koff, loff, coff = 5, 5 + N * KW, 2
    img = rng.integers(0, 2 ** 32, (B, loff + N + 7), dtype=np.uint64) \
        .astype(np.uint32)
    q = rng.integers(0, 2 ** 32, (B, KW), dtype=np.uint64).astype(np.uint32)
    qlen = rng.integers(0, 4 * KW + 1, B).astype(np.int32)
    keys = img[:, koff:loff].reshape(B, N, KW)
    cut = rng.integers(0, KW + 1, (B, N))
    share = (np.arange(KW)[None, None, :] < cut[:, :, None]) \
        & (rng.random((B, N, 1)) < 0.7)
    keys[:] = np.where(share, q[:, None, :], keys)
    img[:, loff:loff + N] = rng.integers(0, 4 * KW + 1, (B, N))
    counts = [0, N + 5, 2 ** 31 + 3, 2 ** 32 - 1, N, N - 1, 1]
    counts += list(rng.integers(0, N + 1, B - len(counts)))
    img[:, coff] = np.array(counts, dtype=np.uint64).astype(np.uint32)
    return q, qlen, img, dict(keys_off=koff, lens_off=loff, count_off=coff,
                              n_keys=N, key_words=KW)


def _merge_case(B, N, L, seed):
    """The reference sweep's leaves (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    nitems = rng.integers(0, N + 1, (B,)).astype(np.int32)
    nlog = rng.integers(0, L + 1, (B,)).astype(np.int32)
    backptr = rng.integers(0, N + 1, (B, L)).astype(np.int32)
    hints = np.stack([rng.integers(0, j + 1, (B,)) for j in range(L)],
                     axis=1).astype(np.int32)
    return nitems, nlog, backptr, hints


#: (n_keys, key_words) of the block-mode search sweep: every N of
#: {3, 64, 80, 300} with every KW of {1, 3, 4, 8, 12} (8 the stores'
#: width, the others the generic instance), then keys too wide for one
#: candidate beside the query (passes of lanes)
BLOCK_SEARCH = [(n, kw) for n in (3, 64, 80, 300) for kw in (1, 3, 4, 8, 12)] \
    + [(7, 1022), (40, 1500)]


def _block_case(N, KW, B=12):
    """Block-mode search inputs on full-range lanes (``_search_case``)
    whose valid masks are all zero (row 0), full (row 1) and not a prefix
    (row 2, every other candidate), random in the other rows."""
    q, qlen, keys, klens, valid = _search_case(B, N, KW, N + KW, 2 ** 32)
    valid[0] = 0
    valid[1] = 1
    valid[2, ::2] = 0
    return q, qlen, keys, klens, valid


def _offset_view(t):
    """``t``'s values in a contiguous tensor of its shape that starts one
    element into a larger buffer: 4 bytes off any 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


#: (B, N, L) of the reference's leaf-merge sweep and more leaves of the
#: generic instance (L = 32 and 33, past the register instance's 16)
MERGE_SWEEP = [(4, 8, 4), (64, 64, 16), (33, 16, 8), (9, 40, 40),
               (20, 64, 32), (20, 64, 33)]


def _wild_merge_case(B, N, L, seed):
    """Leaves of int32 words from the whole range (``B >= 3``): counts in
    [-3, cap + 4], back pointers and hints whose ranks wrap, half the rows'
    hints in [0, L]; then leaf 0's one live log entry ranks INT32_MAX,
    leaf 1's equals sorted item 2's rank (or the last item's), and leaf
    2's two live entries rank equal."""
    rng = np.random.default_rng(seed)
    nitems, nlog = (rng.integers(-3, n + 4, (B,)).astype(np.int32)
                    for n in (N, L))
    backptr, hints = (rng.integers(-2 ** 31, 2 ** 31, (B, L))
                      .astype(np.int32) for _ in range(2))
    hints[::2] %= L + 1
    if L >= 1:
        nlog[0], backptr[0, 0], hints[0, 0] = 1, 0, 2 ** 31 - 1
    if L >= 1 and N >= 1:
        nlog[1], nitems[1] = 1, N
        backptr[1, 0], hints[1, 0] = min(2, N - 1), L
    if L >= 2:
        nlog[2] = 2
        backptr[2, :2], hints[2, :2] = (3, 2), (0, L + 1)
    return nitems, nlog, backptr, hints


#: (B, H, KVH, D, P, PPS): the reference's sweep (tests/test_kernels.py),
#: then G = 1 with D = 80, G = 8 with D = 128, G = 2 with D = 256 (as
#: gemma3-12b), G = 16, and a long case whose live lengths span many of
#: the kernel's spans; then seamless-m4t-medium's heads (16 over 16 KV
#: heads, G = 1, D = 64: 16 threads a head, 16 value phases), short and
#: over several spans, and pixtral-12b's (32 over 8, G = 4, D = 128) over
#: several spans
PAGED_SWEEP = [(2, 4, 2, 16, 8, 3), (4, 8, 8, 32, 16, 2), (2, 8, 2, 16, 8, 4),
               (3, 4, 4, 80, 8, 3), (2, 16, 2, 128, 16, 3),
               (2, 4, 2, 256, 16, 3), (2, 16, 1, 32, 8, 3),
               (3, 8, 2, 64, 32, 24), (2, 16, 16, 64, 16, 3),
               (3, 16, 16, 64, 32, 24), (2, 32, 8, 128, 32, 24)]


def _paged_case(B, H, KVH, D, P, PPS, seed, NP=16, start_hi=2):
    """The reference sweep's paged-attention inputs (tests/test_kernels.py),
    f32: random pages, seq_lens in [1, P * PPS], start_pos below seq_lens
    (every window holds at least one position) and below ``start_hi``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(NP, P, KVH, D)).astype(np.float32)
    vp = rng.normal(size=(NP, P, KVH, D)).astype(np.float32)
    bt = rng.integers(0, NP, (B, PPS)).astype(np.int32)
    sl = rng.integers(1, P * PPS + 1, (B,)).astype(np.int32)
    start = np.minimum(rng.integers(0, start_hi, (B,)), sl - 1) \
        .astype(np.int32)
    return q, kp, vp, bt, sl, start


@pytest.mark.parametrize("B,N,KW,lane_hi", [
    (8, 16, 4, 60), (128, 64, 8, 60), (50, 8, 2, 60), (3, 80, 8, 60),
    (256, 64, 8, 2 ** 32), (40, 8, 8, 2 ** 32)])
def test_key_search_kernel_matches_plain(cuda, B, N, KW, lane_hi):
    args = [_i32(a, cuda) for a in _search_case(B, N, KW, B + N, lane_hi)]
    build.reset_launches()
    got = key_search.key_search(*args)
    assert build.LAUNCHES["key_search"] == 1
    want = ref.key_search_ref(*args)
    assert got.dtype == torch.int32 and torch.equal(want, got)
    assert bool((got >= 0).any())


@pytest.mark.parametrize("case", [f"{n}x{kw}" for n, kw in BLOCK_SEARCH])
def test_key_search_block_kernel_sweep(cuda, case):
    """The block-mode kernel at every N and KW of the sweep (passes of
    lanes for the widest keys), valid masks all zero, full and not a
    prefix; then the same keys in a view at a 4-byte offset.  One launch
    each, equal to the plain version."""
    n, kw = map(int, case.split("x"))
    args = [_i32(a, cuda) for a in _block_case(n, kw)]
    want = ref.key_search_ref(*args)
    for keys in (args[2], _offset_view(args[2])):
        build.reset_launches()
        got = key_search.key_search(args[0], args[1], keys, *args[3:])
        assert build.LAUNCHES["key_search"] == 1
        assert got.dtype == torch.int32 and torch.equal(want, got)
    assert bool((want >= 0).any()) and int(want[0]) == -1


@pytest.mark.parametrize("B", [1, 255, 256, 257])
def test_key_search_block_kernel_batch_edges(cuda, B):
    """Batches around the smoke's 256 at the stores' block (64 keys of 8
    lanes), the keys aligned and at a 4-byte offset: the last block of
    warps partly empty."""
    args = [_i32(a, cuda) for a in _search_case(B, 64, 8, B, 2 ** 32)]
    want = ref.key_search_ref(*args)
    for keys in (args[2], _offset_view(args[2])):
        build.reset_launches()
        got = key_search.key_search(args[0], args[1], keys, *args[3:])
        assert build.LAUNCHES["key_search"] == 1
        assert torch.equal(want, got)


@pytest.mark.parametrize("count_top_bit", [False, True])
def test_key_search_image_kernel_matches_plain(cuda, count_top_bit):
    """Random image rows with planted sorted blocks; with
    ``count_top_bit`` half the live counts read as negative int32."""
    q, qlen, img, kwargs = _image_case(SMALL, 70, 5, count_top_bit)
    args = [_i32(a, cuda) for a in (q, qlen, img)]
    got = key_search.key_search_image(*args, **kwargs)
    want = ref.key_search_image_ref(*args, **kwargs)
    assert torch.equal(want, got) and int(got.max()) >= 0
    if count_top_bit:
        assert bool((got[1::2] == -1).all())


@pytest.mark.parametrize("case", [
    *(f"{g}-{blk}" for g in ("default", "small")
      for blk in ("sorted", "shortcut")),
    *(f"wild-{n}x{kw}" for n, kw in WILD_IMAGE)])
def test_key_search_image_kernel_sweep(cuda, case):
    """The image-mode kernel at the stores' blocks (the default geometry's
    and SMALL's, both blocks, half the counts with the top bit set) and on
    synthetic rows: a block that needs two chunks, widths that take the
    generic instance, counts of 0, above n_keys and negative, full-range
    lanes with ties decided by length.  One launch each, equal to the
    plain version."""
    kind, rest = case.split("-", 1)
    if kind == "wild":
        n, kw = map(int, rest.split("x"))
        q, qlen, img, kwargs = _wild_image_case(n, kw, n + kw)
    else:
        cfg = HoneycombConfig() if kind == "default" else SMALL
        q, qlen, img, kwargs = _image_case(cfg, 70, 7, True, rest)
    args = [_i32(a, cuda) for a in (q, qlen, img)]
    build.reset_launches()
    got = key_search.key_search_image(*args, **kwargs)
    assert build.LAUNCHES["key_search_image"] == 1
    want = ref.key_search_image_ref(*args, **kwargs)
    assert got.dtype == torch.int32 and torch.equal(want, got)
    assert bool((got >= 0).any()) and bool((got == -1).any())


@pytest.mark.parametrize("B,N,L,wild", [(4, 8, 4, False),
                                        (64, 64, 16, False),
                                        (33, 16, 8, False),
                                        (300, 64, 16, True),
                                        (9, 40, 40, True)])
def test_leaf_merge_kernel_matches_plain(cuda, B, N, L, wild):
    """The reference sweep's leaves and, with ``wild``, int32 words from
    the whole range (counts past the caps or negative, back pointers and
    hints whose ranks wrap): ``perm`` must be equal in all T positions."""
    rng = np.random.default_rng(B + N + L)
    if wild:
        nitems, nlog = (rng.integers(-3, n + 4, (B,)).astype(np.int32)
                        for n in (N, L))
        backptr, hints = (rng.integers(-2 ** 31, 2 ** 31, (B, L))
                          .astype(np.int32) for _ in range(2))
        hints[::2] %= L + 1
    else:
        nitems, nlog, backptr, hints = _merge_case(B, N, L, B + N + L)
    args = [_i32(a, cuda) for a in (nitems, nlog, backptr, hints)]
    build.reset_launches()
    perm, valid = leaf_merge.leaf_merge(*args, node_cap=N, log_cap=L)
    assert build.LAUNCHES["leaf_merge"] == 1
    wp, wv = ref.leaf_merge_ref(*args, node_cap=N, log_cap=L)
    assert torch.equal(wp, perm) and torch.equal(wv, valid)
    assert torch.equal(perm.sort(dim=1).values,
                       torch.arange(N + L, device=cuda,
                                    dtype=torch.int32).expand(B, -1))


@pytest.mark.parametrize("B,N,L", MERGE_SWEEP)
@pytest.mark.parametrize("wild", [False, True])
def test_leaf_merge_kernel_instances(cuda, B, N, L, wild):
    """Both instances of the merge (a half-warp a leaf, the generic one)
    on the reference's leaves and on wild ones
    (``_wild_merge_case``: a live rank of INT32_MAX, one equal to a sorted
    rank, two log ranks equal, ranks that wrap, counts past the caps and
    negative).  One launch, equal to the plain version in all T
    positions."""
    case = _wild_merge_case(max(B, 3), N, L, B + N + L) if wild \
        else _merge_case(B, N, L, B + N + L)
    args = [_i32(a, cuda) for a in case]
    build.reset_launches()
    perm, valid = leaf_merge.leaf_merge(*args, node_cap=N, log_cap=L)
    assert build.LAUNCHES["leaf_merge"] == 1
    wp, wv = ref.leaf_merge_ref(*args, node_cap=N, log_cap=L)
    assert torch.equal(wp, perm) and torch.equal(wv, valid)


def test_ksu_rsu_kernels_take_empty_batches(cuda):
    """B = 0 returns empty results without a launch."""
    build.reset_launches()
    e1 = torch.zeros(0, dtype=torch.int32, device=cuda)
    z = torch.zeros(0, 64, dtype=torch.int32, device=cuda)
    q = torch.zeros(0, 8, dtype=torch.int32, device=cuda)
    assert key_search.key_search(
        q, e1, torch.zeros(0, 64, 8, dtype=torch.int32, device=cuda), z,
        z).shape == (0,)
    assert key_search.key_search_image(
        q, e1, torch.zeros(0, 1273, dtype=torch.int32, device=cuda),
        keys_off=7, lens_off=519, count_off=1, n_keys=64,
        key_words=8).shape == (0,)
    perm, valid = leaf_merge.leaf_merge(
        e1, e1, *(torch.zeros(0, 16, dtype=torch.int32, device=cuda),) * 2,
        node_cap=64, log_cap=16)
    assert perm.shape == valid.shape == (0, 80)
    assert build.LAUNCHES["key_search"] == build.LAUNCHES[
        "key_search_image"] == build.LAUNCHES["leaf_merge"] == 0


@pytest.mark.parametrize("case", ["offset_past_row", "wrong_dtype",
                                  "on_cpu", "q_width", "merge_too_wide"])
def test_ksu_rsu_kernels_reject_bad_input(cuda, case):
    img = torch.zeros(4, 100, dtype=torch.int32, device=cuda)
    q = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    qlen = torch.zeros(4, dtype=torch.int32, device=cuda)
    kw = dict(keys_off=10, lens_off=50, count_off=0, n_keys=8, key_words=2)
    if case == "offset_past_row":
        kw["lens_off"] = 95
    elif case == "wrong_dtype":
        img = img.float()
    elif case == "on_cpu":
        q = q.cpu()
    elif case == "q_width":
        q = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    if case == "merge_too_wide":
        e = torch.zeros(2, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError):
            leaf_merge.leaf_merge(e, e, *(torch.zeros(
                2, 2000, dtype=torch.int32, device=cuda),) * 2,
                node_cap=64, log_cap=2000)
        return
    with pytest.raises(ValueError):
        key_search.key_search_image(q, qlen, img, **kw)


def test_ksu_rsu_kernels_on_live_store_rows(cuda):
    """On a small CUDA store's own image rows: the shortcut-block and
    sorted-block searches of every row for random queries, and the merge
    of every leaf row, equal their plain versions."""
    cfg = SMALL
    st = _store(cfg, 300, cuda)
    image = st.export_snapshot().image
    offs = NodeImageLayout.for_config(cfg).offsets()
    rng = np.random.default_rng(6)
    S = image.shape[0]
    key, klen = _keys([int_key(int(i)) for i in rng.integers(0, 320, S)],
                      cfg, cuda)
    for keys, lens, count, n in (("sc_keys", "sc_keylen", "n_shortcuts",
                                  cfg.n_shortcuts),
                                 ("skeys", "skeylen", "nitems",
                                  cfg.node_cap)):
        kw = dict(keys_off=offs[keys][0], lens_off=offs[lens][0],
                  count_off=offs[count][0], n_keys=n,
                  key_words=cfg.key_words)
        got = key_search.key_search_image(key, klen, image, **kw)
        assert torch.equal(ref.key_search_image_ref(key, klen, image, **kw),
                           got)
    leaves = image[image[:, offs["ntype"][0]] == LEAF]

    def col(name, width=1):
        o = offs[name][0]
        return leaves[:, o:o + width].contiguous().squeeze(1)
    args = (col("nitems"), col("nlog"), col("log_backptr", cfg.log_cap),
            col("log_hint", cfg.log_cap))
    got = leaf_merge.leaf_merge(*args, node_cap=cfg.node_cap,
                                log_cap=cfg.log_cap)
    want = ref.leaf_merge_ref(*args, node_cap=cfg.node_cap,
                              log_cap=cfg.log_cap)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert bool((args[1] > 0).any())


#: kernel vs plain: f32 to 1e-5 (the sums run in another order); a bf16
#: output to one bf16 ulp (2**-7 relative): both round nearly the same f32
PAGED_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}


def _paged_args(case, device, q_dtype, kv_dtype):
    q, kp, vp, bt, sl, start = (torch.from_numpy(a).to(device) for a in case)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), bt, sl, start)


def _paged_check(args, **kw):
    build.reset_launches()
    got = paged_attention.paged_attention(*args, **kw)
    assert build.LAUNCHES["paged_attention"] == 1
    want = ref.paged_attention_ref(*args, **kw)
    assert got.dtype == want.dtype == args[0].dtype
    torch.testing.assert_close(got, want, **PAGED_TOL[got.dtype])
    return got


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,KVH,D,P,PPS", PAGED_SWEEP)
def test_paged_attention_kernel_matches_plain(cuda, B, H, KVH, D, P, PPS,
                                              q_dtype, kv_dtype):
    case = _paged_case(B, H, KVH, D, P, PPS, seed=B + H + D, start_hi=P)
    _paged_check(_paged_args(case, cuda, q_dtype, kv_dtype), softcap=30.0)
    _paged_check(_paged_args(case, cuda, q_dtype, kv_dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_page_edges_windows_scratch(cuda, dtype):
    """seq_lens on page edges and one past them, windows starting deep
    inside the sequence, block-table entries past seq_lens pointing at page
    0, P = 256 as the serving path has it, and B = 1."""
    B, H, KVH, D, P, PPS = 6, 16, 2, 128, 256, 5
    q, kp, vp, bt, sl, start = _paged_case(B, H, KVH, D, P, PPS, seed=9,
                                           NP=24)
    sl[:] = [P, 2 * P, 2 * P + 1, 5 * P, 1, 3 * P - 1]
    start[:] = [0, P - 1, 2 * P, 4 * P + 7, 0, 300]
    for b in range(B):
        bt[b, -(-sl[b] // P):] = 0
    case = (q, kp, vp, bt, sl, start)
    _paged_check(_paged_args(case, cuda, dtype, dtype), scale=0.1)
    one = tuple(a[:1] if a.ndim and a.shape[0] == B else a for a in case)
    _paged_check(_paged_args(one, cuda, dtype, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_windows_start_mid_span(cuda, dtype):
    """Windows that start inside a span, spans wholly below a window and
    past its end, and an empty window, under the wrapper's span plan and
    under plans of short spans, three stages and other tiles."""
    B, H, KVH, D, P, PPS = 5, 8, 2, 64, 32, 24
    q, kp, vp, bt, sl, start = _paged_case(B, H, KVH, D, P, PPS, seed=21,
                                           NP=40)
    sl[:] = [P * PPS, 700, 129, 64, 300]
    start[:] = [200, 77, 120, 64, 8]       # sequence 3 sees nothing
    for b in range(B):
        bt[b, -(-sl[b] // P):] = 0
    args = _paged_args((q, kp, vp, bt, sl, start), cuda, dtype, dtype)
    got = _paged_check(args, softcap=30.0)
    assert float(got[3].float().abs().max()) == 0.0
    elem = 2 if dtype == torch.bfloat16 else 4
    want = ref.paged_attention_ref(*args, softcap=30.0)
    for span, tile, stages in ((16, 16, 2), (48, 16, 3), (64, 32, 2),
                               (96, 32, 3), (128, 64, 2)):
        plan = paged_attention.SpanPlan(
            span, -(-P * PPS // span), tile, stages,
            paged_attention.smem_bytes(H // KVH, D, tile, stages, elem))
        got = paged_attention._launch(*args, plan, D ** -0.5, 30.0)
        torch.testing.assert_close(got, want, **PAGED_TOL[dtype])


def test_paged_attention_kernel_empty_window_gives_zeros(cuda):
    case = list(_paged_case(3, 8, 2, 32, 8, 3, seed=4))
    case[5] = case[5].copy()
    case[5][1] = case[4][1]
    got = _paged_check(_paged_args(case, cuda, torch.float32,
                                   torch.float32))
    assert float(got[1].abs().max()) == 0.0 and float(got.abs().max()) > 0


@pytest.mark.parametrize("bad", ["float16", "int32", "mixed_pools",
                                 "noncontiguous", "heads", "head_dim"])
def test_paged_attention_kernel_rejects_bad_input(cuda, bad):
    B, H, KVH, D = 2, 8, 2, 32
    q, kp, vp, bt, sl, start = _paged_args(
        _paged_case(B, H, KVH, D, 8, 3, seed=5), cuda, torch.float32,
        torch.float32)
    if bad == "float16":
        q = q.half()
    elif bad == "int32":
        kp, vp = kp.int(), vp.int()
    elif bad == "mixed_pools":
        vp = vp.bfloat16()
    elif bad == "noncontiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "heads":
        q = torch.zeros(B, 7, D, device=cuda)
    else:
        q, kp, vp = q[..., :12].contiguous(), kp[..., :12].contiguous(), \
            vp[..., :12].contiguous()
    build.reset_launches()
    with pytest.raises(ValueError):
        paged_attention.paged_attention(q, kp, vp, bt, sl, start)
    assert build.LAUNCHES["paged_attention"] == 0


@pytest.mark.parametrize("arch", ["qwen2p5_3b", "gemma2_27b", "pixtral_12b",
                                  "seamless_m4t_medium"])
def test_serving_engine_on_cuda_matches_cpu(cuda, arch):
    """The smoke-config engine on the card against the same engine on the
    CPU: with the parameters in f32 the greedy tokens, stats and page
    tables agree (bf16 pools, so the kernel runs with f32 q over bf16
    pages); with bf16 parameters, the decode logits of a prefilled batch
    agree to 5e-2 (bf16 activations round at other steps on the card)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config(arch)
    params = sc.init(tf.schema(cfg), torch.Generator().manual_seed(0), "cpu")
    f32 = sc.map_tree(lambda t: t.float(), params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, (int(n),))
               for n in rng.integers(5, 45, 5)]
    outs, engines = [], []
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, f32, batch_size=2, max_seq=128,
                            page_size=16, device=dev)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        build.reset_launches()
        got = eng.run_until_done()
        outs.append([got[r] for r in rids])
        engines.append(eng)
    assert outs[0] == outs[1]
    assert engines[0].stats == engines[1].stats
    assert build.LAUNCHES["paged_attention"] == \
        cfg.n_layers * engines[1].stats["decode_steps"]
    assert build.LAUNCHES["fused_get"] == engines[1].stats["decode_steps"]

    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32)))
    logits = []
    for dev in ("cpu", cuda):
        p = sc.map_tree(lambda t: t.to(dev), params)
        _, cache = tf.prefill(p, cfg, toks.to(dev), 16, 29)
        cache = cache._replace(seq_lens=torch.tensor(
            [28, 25], dtype=torch.int32, device=dev))
        step = []
        for i in range(3):
            lg, cache = tf.decode_step(p, cfg, cache,
                                       toks[:, i:i + 1].to(dev), 16)
            step.append(lg.float().cpu())
        logits.append(torch.stack(step))
    torch.testing.assert_close(logits[1], logits[0], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mamba2_1p3b",
                                  "jamba_v0p1_52b"])
def test_moe_ssm_engine_on_cuda_matches_cpu(cuda, arch):
    """The MoE, SSM and hybrid smoke engines on the card against the same
    engines on the CPU, parameters in f32: greedy tokens, stats and page
    tables agree, slots reused (5 requests in 2 slots); paged attention
    launches once per attention layer and decode step (none for mamba2),
    the fused GET once a step.  Then the decode logits of a prefilled
    batch, caches and states in f32, agree to 1e-3 (the devices sum in
    other orders; a smoke router's near tie would flip a whole expert,
    so bf16 is not compared)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config(arch)
    params = sc.map_tree(lambda t: t.float(), sc.init(
        tf.schema(cfg), torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, (int(n),))
               for n in rng.integers(5, 45, 5)]
    outs, engines = [], []
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, params, batch_size=2, max_seq=128,
                            page_size=16, device=dev)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        build.reset_launches()
        got = eng.run_until_done()
        outs.append([got[r] for r in rids])
        engines.append(eng)
    assert outs[0] == outs[1]
    assert engines[0].stats == engines[1].stats
    steps = engines[1].stats["decode_steps"]
    attn_layers = cfg.n_superblocks * sum(
        kind != "M" for kind, _ in tf.layer_kinds(cfg))
    assert build.LAUNCHES["paged_attention"] == attn_layers * steps
    assert build.LAUNCHES["fused_get"] == steps

    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 48)))
    logits = []
    for dev in ("cpu", cuda):
        p = sc.map_tree(lambda t: t.to(dev), params)
        _, cache = tf.prefill(p, cfg, toks.to(dev), 16,
                              torch.tensor([27, 31], device=dev))
        cache = cache._replace(seq_lens=torch.tensor(
            [28, 32], dtype=torch.int32, device=dev))
        step = []
        for i in range(3):
            lg, cache = tf.decode_step(p, cfg, cache,
                                       toks[:, i:i + 1].to(dev), 16)
            step.append(lg.float().cpu())
        logits.append(torch.stack(step))
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-3, atol=1e-3)


def _decode_room(layers, B, pps, room, zeros):
    """Prefill's caches ``layers`` ({"l<i>": {kind: [n, B * pps, ...]}})
    in pools of ``room`` pages a sequence, made by ``zeros(t, n_pages)``:
    sequence b's pages first at b * room (identity block tables of
    ``room`` columns).  Works on tensors and numpy arrays alike."""
    out = {}
    for name, c in layers.items():
        out[name] = {}
        for kind, t in c.items():
            big = zeros(t, B * room)
            for b in range(B):
                big[:, b * room:b * room + pps] = t[:, b * pps:(b + 1) * pps]
            out[name][kind] = big
    return out


@pytest.mark.parametrize("arch", ["pixtral_12b", "seamless_m4t_medium"])
def test_encdec_steps_on_cuda_matches_cpu(cuda, arch):
    """``launch/steps.py`` on the card against the CPU, smoke configs in
    f32: ``prefill_step`` (pixtral from embeddings, seamless encoding
    its frames) and 3 ``decode_step``s against its ``enc_out``, in pools
    of ``decode_cache_abstract``'s shapes with prefill's pages copied in;
    logits and ``enc_out`` agree to 1e-3, and paged attention launches
    once per layer and decode step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ShapeConfig
    cfg = get_smoke_config(arch)
    params = sc.map_tree(lambda t: t.float(), sc.init(
        tf.schema(cfg), torch.Generator().manual_seed(0), "cpu"))
    B, S, P = 2, 32, 16
    rng = np.random.default_rng(2)
    host = {}
    if cfg.embeds_in:
        host["embeds"] = torch.from_numpy(
            rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))
    else:
        host["tokens"] = torch.from_numpy(
            rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.n_enc_layers:
        host["enc_embeds"] = torch.from_numpy(rng.normal(
            size=(B, S // cfg.enc_seq_divisor, cfg.d_model))
            .astype(np.float32))
    nxt = torch.from_numpy(rng.integers(1, cfg.vocab, (3, B, 1))
                           .astype(np.int32))
    spec = steps.decode_cache_abstract(
        cfg, ShapeConfig("decode", "decode", 2 * S, B, P))
    room, pps = spec.block_tables.shape[1], S // P
    outs = []
    for dev in ("cpu", cuda):
        model = tf.Transformer(cfg, sc.map_tree(lambda t: t.to(dev),
                                                params))
        build.reset_launches()
        logits, cache, enc_out = steps.prefill_step(
            model, {k: v.to(dev) for k, v in host.items()}, P)
        layers = _decode_room(cache.layers, B, pps, room, lambda t, n: (
            t.new_zeros((t.shape[0], n, *t.shape[2:]))))
        assert {n: {k: tuple(t.shape) for k, t in c.items()}
                for n, c in layers.items()} == \
            {n: {k: d.shape for k, d in c.items()}
             for n, c in spec.layers.items()}
        cache = tf.DecodeCache(layers, torch.arange(
            B * room, dtype=torch.int32, device=dev).view(B, room),
            cache.seq_lens)
        rows = [logits]
        for i in range(3):
            lg, cache = steps.decode_step(model, cache, nxt[i].to(dev), P,
                                          enc_out=enc_out)
            rows.append(lg)
        outs.append((torch.stack(rows).cpu(),
                     None if enc_out is None else enc_out.cpu()))
    assert build.LAUNCHES["paged_attention"] == cfg.n_layers * 3
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-3, atol=1e-3)
    if cfg.n_enc_layers:
        torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-3,
                                   atol=1e-3)
    else:
        assert outs[1][1] is None


# ------------------------------------------------------------ the analysis
#: device -> host read-backs a dispatch makes on the card, pinned: the row
#: and multi-field scatters read the rows' bounds back (``ref.check_rows``),
#: the log replay its verdict flag; the fused reads, the KSU/RSU, paged
#: attention and the grouped MoE none
KERNEL_READBACKS = {
    "ops.snapshot_delta_scatter": 1, "ops.snapshot_image_scatter": 1,
    "ops.snapshot_multi_scatter": 1, "ops.log_replay_scatter": 1,
    "ops.batched_get_fused": 0, "ops.batched_scan_fused": 0,
    "ops.key_search": 0, "ops.key_search_image": 0, "ops.leaf_merge": 0,
    "ops.paged_attention": 0, "ops.moe_grouped": 0}
#: launches of its own kernel a dispatch, where not 1: the grouped MoE's
#: dispatch, gather, gate/up, down and combine
KERNEL_LAUNCHES = {"ops.moe_grouped": 5}


def test_kernel_check_clean_on_the_card(cuda):
    """Every entry point of kernels/ops.py on the card: no finding, one
    launch of its own kernel a dispatch (``KERNEL_LAUNCHES`` where a
    dispatch takes several) and none of another, the pinned
    read-backs, in-place scatters that return their destination with an
    allocation rise below one destination, and every shared-memory figure
    under the device's opt-in limit, the fused read's mirror equal to its
    launcher's."""
    from repro_torch.analysis import kernel_check
    findings, runs = kernel_check.run_kernel_checks("cuda")
    assert findings == [], "\n".join(map(str, findings))
    limit = kernel_check.smem_limit(cuda)
    assert limit == torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin
    assert {e.name for e, _ in runs} == set(KERNEL_READBACKS)
    for entry, rec in runs:
        n = KERNEL_LAUNCHES.get(entry.name, 1)
        assert rec.launches[entry.counter] == n, entry.name
        assert sum(rec.launches.values()) == n, entry.name
        assert rec.readbacks == KERNEL_READBACKS[entry.name] \
            == entry.readbacks, (entry.name, rec.readbacks)
        assert max(b for _, b in rec.smem) <= limit
        if entry.in_place:
            assert rec.aliased and rec.alloc_rise < rec.dst_bytes, \
                (entry.name, rec.alloc_rise, rec.dst_bytes)
        if entry.fused:
            assert rec.smem_launcher and all(
                m == c for _, m, c in rec.smem_launcher)


@pytest.mark.parametrize("cfg", [
    HoneycombConfig(), SMALL,
    HoneycombConfig(node_cap=64, log_cap=16, n_shortcuts=8, key_words=4),
    HoneycombConfig(key_words=3, val_words=5, max_scan_items=32)],
    ids=["default", "small", "page_table", "odd"])
def test_fused_read_smem_mirror_equals_launcher(cuda, cfg):
    for C in (0, 1, cfg.cache_slots, 1000):
        assert fused_read.smem_bytes(cfg, C) \
            == fused_read.launcher_smem_bytes(cfg, C), C


@pytest.mark.parametrize("read", ["get", "scan"])
def test_standby_read_raises_before_any_launch(cuda, read):
    from repro_torch.analysis import epochsan
    st = _store(SMALL, 200, cuda)
    st.export_snapshot()
    with epochsan.enabled() as san:
        st.update(int_key(3), b"x")
        st.begin_export()                     # a delta staged, not flipped
        before = dict(build.LAUNCHES)
        with pytest.raises(epochsan.EpochSanViolation) as ei:
            if read == "get":
                st._device_get(st._standby, [int_key(3)])
            else:
                st._device_scan(st._standby, [(int_key(3), int_key(5))],
                                None)
        assert ei.value.kind == epochsan.STANDBY_READ
        assert build.LAUNCHES == before
        st.flip()
        assert st.get_batch([int_key(3)]) == [b"x"]
    assert san.stats.violations == 1 and san.stats.stagings == 1


def test_cuda_paths_under_strict_epochsan(cuda):
    """A small CUDA store, a replicated group on the log feed and a
    service drain under the strict sanitizer: no violation, and every
    seam the paths pass counted."""
    from repro_torch.analysis import epochsan
    from repro_torch.core import HoneycombService, Get, Put, Scan
    with epochsan.enabled() as san:
        st = _store(SMALL, 200, cuda)
        st.export_snapshot()
        for i in range(0, 200, 3):
            st.update(int_key(i), b"w")
        st.export_snapshot()
        st.collect_garbage()
        assert st.get_batch([int_key(3)]) == [b"w"]
        rs = ShardedHoneycombStore(
            SMALL, heap_capacity=256, shards=2,
            boundaries=uniform_int_boundaries(200, 2),
            replication=ReplicationConfig(2, "round_robin", feed="log"),
            device=cuda)
        for i in range(200):
            rs.put(int_key(i), b"v")
        rs.export_snapshot()
        for e in range(4):
            for i in range(e, 200, 17):
                rs.update(int_key(i), b"e%d" % e)
            if e == 2:
                [g.collect_garbage() for g in rs.shards]
            rs.export_snapshot()
            for r in (0, 1):
                assert rs.get_batch([int_key(e)], replica=r) == [b"e%d" % e]
        svc = HoneycombService(_sharded_legacy(cuda), batch_size=8,
                               pipeline="pipelined")
        ts = [svc.submit(Put(int_key(i), b"s")) for i in range(0, 200, 5)]
        ts += [svc.submit(Get(int_key(i))) for i in range(0, 200, 10)]
        ts.append(svc.submit(Scan(int_key(0), int_key(20),
                                  expected_items=8)))
        svc.drain()
        assert all(t.done for t in ts)
    st_ = san.stats
    assert san.violations == [] and st_.violations == 0
    assert min(st_.read_checks, st_.stagings, st_.flips, st_.gc_audits,
               st_.dispatch_checks) > 0, st_


def _sharded_legacy(device):
    return ShardedHoneycombStore(
        dataclasses.replace(SMALL, layout="legacy"), heap_capacity=256,
        shards=2, boundaries=uniform_int_boundaries(200, 2),
        replication=ReplicationConfig(2, "round_robin"), device=device)


@pytest.mark.parametrize("name", ["live_sharded_smoke",
                                  "live_replicated_smoke"])
def test_live_store_smokes_on_cuda_match_cpu(cuda, name):
    """The live store dry run at its defaults on the card: its own
    assertions hold (the fused kernel equals the per-level reference read
    on every shard and follower), its kernels launch, and with the clock
    frozen the whole result, meters and telemetry, equals the CPU run's."""
    from repro_torch.core import CLOCK
    from repro_torch.kernels import ops
    from repro_torch.launch import store_dryrun
    out = []
    for device in ("cpu", cuda):
        ops.reset_read_dispatches()
        build.reset_launches()
        with CLOCK.frozen():
            out.append(getattr(store_dryrun, name)(device=device))
    launches = dict(build.LAUNCHES)
    assert launches["fused_get"] > 0 and launches["row_scatter"] > 0
    if name == "live_replicated_smoke":
        assert launches["log_replay"] > 0
    assert out[1] == out[0]


def test_cpu_baseline_matches_cuda_store(cuda):
    """The port's CPU baseline and a HoneycombStore on the card, 2^14 keys
    loaded and rewritten alike: equal GET and SCAN answers."""
    from repro_torch.baselines import CpuOrderedStore
    cfg = HoneycombConfig()
    n = 1 << 14
    hc = HoneycombStore(cfg, device=cuda)
    cp = CpuOrderedStore(node_cap=cfg.node_cap)
    rng = np.random.default_rng(2)
    for i in rng.permutation(n):
        hc.put(int_key(int(i)), b"v%06d" % i)
        cp.put(int_key(int(i)), b"v%06d" % i)
    for i in rng.integers(0, n, 2000):
        k = int_key(int(i))
        if rng.random() < 0.7:
            hc.update(k, b"u%06d" % i)
            cp.update(k, b"u%06d" % i)
        else:
            hc.delete(k)
            cp.delete(k)
    keys = [int_key(int(i)) for i in rng.integers(0, n + 100, 1024)]
    assert hc.get_batch(keys) == cp.get_batch(keys)
    ranges = [(int_key(int(i)), int_key(int(i) + 7))
              for i in rng.integers(0, n, 1024)]
    assert hc.scan_batch(ranges) == cp.scan_batch(ranges)
    assert cp.stats.gets == 1024 and cp.stats.scans == 1024


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ["qwen2p5_3b", "olmoe_1b_7b",
                                  "mamba2_1p3b"])
def test_train_step_on_cuda_matches_cpu(cuda, arch):
    """``launch/steps.train_step`` (2 microbatches, remat) on the card
    against the CPU, smoke configs in f32 from the same parameters and
    batch (labels with -1s): loss and gnorm to 1e-4 relative, every new
    parameter and moment to 1e-4 of its leaf's largest magnitude (cuBLAS
    and the CPU sum in other orders, TF32 off), no kernel of the port
    launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    cfg = get_smoke_config(arch)
    params = sc.map_tree(lambda t: t.float(), sc.init(
        tf.schema(cfg), torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)}
    batch["labels"][:, :4] = -1
    outs = []
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            p = sc.map_tree(lambda t: t.to(dev, copy=True), params)
            build.reset_launches()
            p, st, m = steps.train_step(p, opt.init(p), batch, cfg,
                                        opt.AdamWConfig(), accum=2)
            assert not any(build.LAUNCHES.values())
            outs.append((float(m["loss"]), float(m["gnorm"]),
                         [t.detach().cpu()
                          for t in sc.flatten((p, st.mu, st.nu))]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (l0, g0, t0), (l1, g1, t1) = outs
    assert l1 == pytest.approx(l0, rel=1e-4)
    assert g1 == pytest.approx(g0, rel=1e-4)
    for a, b in zip(t0, t1):
        scale = max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_checkpoint_round_trip_from_cuda(cuda, tmp_path):
    """bf16 and f32 leaves and an int32 step saved from the card (async)
    and restored onto it bit for bit; the catalog store lives on the card
    and its floor lookups answer from the host tree; an in-place change
    after ``save`` returns does not reach the checkpoint."""
    from repro_torch.models import schema as sc
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import CheckpointManager
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen, device=cuda)
              .to(torch.bfloat16),
              "b": {"s": torch.randn(32, generator=gen, device=cuda)}}
    state = opt.init(params)._replace(
        step=torch.tensor(5, dtype=torch.int32, device=cuda))
    want = [t.clone() for t in sc.flatten((params, state))]
    ck = CheckpointManager(tmp_path, keep=2)
    assert ck.catalog.device.type == "cuda"
    build.reset_launches()
    ck.save(5, (params, state), blocking=False)
    params["w"].add_(1)                  # the next step, in place
    ck.wait()
    ck.save(9, (params, state))
    assert ck.all_steps() == [5, 9] and ck.latest_step(8) == 5
    (p, s), _ = ck.restore(5, (params, state))
    got = sc.flatten((p, s))
    assert all(t.device.type == "cuda" for t in got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not any(build.LAUNCHES.values())


# ------------------------------------------------------------------ the mesh
@pytest.fixture
def one_rank_mesh(cuda, tmp_path):
    """A one-rank NCCL world and a (1, 1) ("data", "model") mesh on the
    card; the process group is destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _moe_case(E=8, k=2, d=64, f=64, B=4, S=32, seed=0):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as me
    cfg = dataclasses.replace(get_smoke_config("olmoe_1b_7b"), n_experts=E,
                              top_k=k, d_model=d, d_ff=f)
    g = torch.Generator().manual_seed(seed)
    p = {name: torch.randn(spec.shape, generator=g) / spec.shape[-2] ** 0.5
         for name, spec in me.moe_schema(cfg).items()}
    x = torch.randn(B, S, d, generator=g) * 0.5
    return cfg, p, x


def test_ragged_ffn_on_cuda_matches_cpu(cuda):
    """``moe._ragged_ffn`` (the autograd Function) forward and its ragged
    backward on the card against the CPU in f32 (TF32 off), an empty
    group and rows past the groups included."""
    from repro_torch.models import moe as me
    g = torch.Generator().manual_seed(1)
    sizes = [5, 0, 17, 9]
    xs = torch.randn(34, 64, generator=g)
    ws = [torch.randn(s, generator=g) / 8 for s in
          ((4, 64, 96), (4, 64, 96), (4, 96, 64))]
    dy = torch.randn(34, 64, generator=g)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for dev in ("cpu", cuda):
            a = [t.to(dev).requires_grad_(True) for t in (xs, *ws)]
            y = me._ragged_ffn(*a, torch.tensor(sizes, device=dev))
            gr = torch.autograd.grad((y * dy.to(dev)).sum(), a)
            outs.append([t.detach().cpu() for t in (y, *gr)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    assert not outs[1][0][31:].any()


@pytest.mark.parametrize("variant", ["fsliced", "ep"])
def test_mesh_moe_on_one_card_matches_ragged(one_rank_mesh, variant):
    """``moe_fsliced_ragged`` / ``moe_ep_ragged`` under ``shard_map`` on a
    one-rank NCCL mesh on the card against ``moe_ragged`` there: outputs
    and the gradients of x and every parameter in f32 (TF32 off; one
    rank: E_loc = E and cap >= T*k, nothing dropped)."""
    from repro_torch.models import moe as me
    cfg, p, x = _moe_case()
    fn = me.moe_fsliced_ragged if variant == "fsliced" else me.moe_ep_ragged
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for run in (lambda q, y: fn(q, y, cfg, mesh=one_rank_mesh,
                                    dp_axes=("data",)).full_tensor(),
                    lambda q, y: me.moe_ragged(q, y, cfg)):
            q = {k: v.cuda().requires_grad_(True) for k, v in p.items()}
            y = x.cuda().requires_grad_(True)
            out = run(q, y)
            gr = torch.autograd.grad((out * ct.cuda()).sum(),
                                     [y] + [q[k] for k in sorted(q)])
            outs.append([t.detach().cpu() for t in (out, *gr)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for a, b in zip(outs[1], outs[0]):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_paged_attention_local_on_one_card_is_decode_attention(
        one_rank_mesh):
    """``paged_attention_local`` on a one-rank mesh on the card (the
    rebased block table is the table itself) against the scatter and
    ``kernels/ops.paged_attention`` that ``decode_attention`` runs: the
    same kernel, so output and pools bit for bit; one launch of the
    paged-attention kernel each."""
    from repro_torch.distributed.paged_attention import paged_attention_local
    from repro_torch.kernels import ops
    B, H, KVH, D, P, PPS = 8, 16, 2, 128, 16, 8
    g = torch.Generator().manual_seed(3)
    q = torch.randn(B, H, D, generator=g).to(torch.bfloat16).cuda()
    kp = torch.randn(B * PPS, P, KVH, D, generator=g).to(torch.bfloat16) \
        .cuda()
    vp = torch.randn(kp.shape, generator=g).to(torch.bfloat16).cuda()
    bt = torch.arange(B * PPS, dtype=torch.int32).reshape(B, PPS).cuda()
    lens = torch.randint(1, P * PPS - 1, (B,), generator=g,
                         dtype=torch.int32).cuda()
    start = torch.zeros(B, dtype=torch.int32).cuda()
    kn = torch.randn(B, KVH, D, generator=g).to(torch.bfloat16).cuda()
    vn = torch.randn(B, KVH, D, generator=g).to(torch.bfloat16).cuda()
    k1, v1 = kp.clone(), vp.clone()
    rows = torch.arange(B, device="cuda")
    page = bt[rows, lens.long() // P].long()
    k1[page, lens.long() % P] = kn
    v1[page, lens.long() % P] = vn
    build.reset_launches()
    want = ops.paged_attention(q, k1, v1, bt, lens + 1, start,
                               scale=D ** -0.5)
    one = dict(build.LAUNCHES)
    build.reset_launches()
    out, k2, v2 = paged_attention_local(
        q, kp, vp, bt, lens, start, kn, vn, mesh=one_rank_mesh,
        batch_axes=("data",), kv_head_axis="model", head_dim_axis=None,
        page_size=P, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out.full_tensor(), want)
    assert torch.equal(k2.to_local(), k1) and torch.equal(v2.to_local(), v1)
    assert k2.to_local().data_ptr() == kp.data_ptr()     # in place
    assert dict(build.LAUNCHES) == one and sum(one.values()) > 0


# ----------------------------------------------------------- the dry run
def test_dry_run_count_equals_the_card_step(cuda, tmp_path):
    """``launch/dryrun``'s count of qwen2.5-3b at full widths cut to 2
    layers, trained through ``build_step`` on a (1, 1) fake world, equals
    the FLOPs of the same step on the card (a one-rank NCCL world)
    exactly; the loss is finite."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    shape = ShapeConfig("t", "train", seq_len=256, global_batch=2)
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        counted = dryrun.trace_cell(cfg, shape, mesh, grad_accum=2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        built = steps.build_step(cfg, shape, mesh, grad_accum=2)
        params = sc.place(sc.init(tf.schema(cfg), torch.Generator(
            device=cuda).manual_seed(0), cuda), built.in_shardings[0], mesh)
        t = torch.randint(0, cfg.vocab, (2, 257), dtype=torch.int32,
                          device=cuda)
        batch = sc.place({"tokens": t[:, :-1].contiguous(),
                          "labels": t[:, 1:].contiguous()},
                         built.in_shardings[2], mesh)
        with FlopCounterMode(display=False) as fc:
            _, _, m = built.fn(params, opt.init(params), batch)
            loss = float(m["loss"])
    finally:
        dist.destroy_process_group()
    assert fc.get_total_flops() == int(counted.cost["flops"]) > 0
    assert np.isfinite(loss)


def test_store_pipeline_stages_on_cuda(cuda):
    """The store dry run's mesh-scale half on the card at a small shard:
    the staged delta and a second apply equal the plain row scatter, the
    fused GET its plain walk, both stages are timed and the occupancy
    model reads them."""
    from repro_torch.core.read_path import apply_snapshot_delta
    from repro_torch.kernels import ops
    from repro_torch.launch import store_dryrun as sd
    store = sd.live_shard(3000, "cuda")
    base, delta, staged, d, p = sd.stage_delta(store, 64)
    assert d >= 56 and delta.rows.shape[0] >= d
    want = ref.snapshot_image_scatter_ref(base.image.clone(), delta.rows,
                                          delta.image)
    assert torch.equal(staged.image, want)
    again = apply_snapshot_delta(base, delta, cfg=store.cfg)
    assert torch.equal(again.image, want)
    assert torch.equal(again.cache_image, staged.cache_image)
    keys, lanes, lens = sd.read_batch(store, 64, 3000)
    got, gm = ops.batched_get_fused(staged, lanes, lens, cfg=store.cfg)
    plain, pm = ref.batched_get_fused_ref(staged, lanes, lens,
                                          cfg=store.cfg)
    _assert_equal(plain, got)
    assert torch.equal(gm, pm) and bool(got.found.all())
    assert sd.apply_peak_rise(base, delta, store.cfg) \
        >= base.image.numel() * 4
    st = sd.pipeline_stages(store, base, delta, lanes, lens, reps=8)
    assert st["export_ms"] > 0 and st["read_ms"] > 0
    r = sd.mesh_scale(device="cuda", shard_keys=3000)
    assert r["pipeline"]["pipelined_epoch_s"] == max(
        r["pipeline"]["export_stage_s"], r["pipeline"]["read_stage_s"]) > 0
    assert r["temp_bytes"] is not None and r["collective_bytes"] == 0


# ------------------------------------------------ the grouped MoE of prefill
#: (name, E, k, d, f, T): olmoe-1b-7b's and jamba-v0.1-52b's full widths
#: at the docqa cells' prompt lengths
GROUPED_FULL = (("olmoe_512", 64, 8, 2048, 1024, 512),
                ("olmoe_1536", 64, 8, 2048, 1024, 1536),
                ("jamba_2048", 16, 2, 4096, 14336, 2048))
# bf16 products summed in another order than cuBLAS's: a few ulps of h and
# y; outputs of magnitude ~1 (inputs N(0, 1), weights N(0, 1 / K))
GROUPED_BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _grouped_inputs(E, k, d, f, T, dtype, dev, seed=0):
    """Seeded inputs of one grouped FFN with skewed routes: the last
    quarter of the experts get no rows, the first two most of them.
    Returns (x [T, d], gates [T, k] f32, ids [T, k] int64, w_gate, w_up,
    w_down)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, d, generator=g, device=dev).to(dtype)
    skew = torch.zeros(E, device=dev)
    skew[:2] = 2.0
    skew[E - max(1, E // 4):] = -1e9
    logits = torch.randn(T, E, generator=g, device=dev) + skew
    probs, ids = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    gates = probs / probs.sum(-1, keepdim=True)
    w = [(torch.randn(E, a, b, generator=g, device=dev) / a ** 0.5)
         .to(dtype) for a, b in ((d, f), (d, f), (f, d))]
    return (x, gates.contiguous(), ids.contiguous(), *w)


@pytest.mark.parametrize("case", GROUPED_FULL, ids=[c[0] for c in GROUPED_FULL])
def test_moe_grouped_kernel_matches_plain(cuda, case):
    """The grouped FFN's five launches against its plain version on the
    card in bf16 at full widths, skewed routes leaving experts empty: the
    dispatch exactly, h and y within a few ulps, the combine exactly on
    the kernel's own y, the layer within ``GROUPED_BF16_TOL``."""
    from repro_torch.kernels import moe_grouped as mg
    _, E, k, d, f, T = case
    x, gates, ids, wg, wu, wd = _grouped_inputs(E, k, d, f, T,
                                                torch.bfloat16, cuda)
    assert mg.uses_wgmma(x.dtype, d, f)
    build.reset_launches()
    pos, meta = mg.dispatch(ids, E, mg.WGMMA_ROWS)
    xs = mg.gather(x, pos, k)
    h = mg.grouped_gemm(xs, meta, wg, wu, 0, True)
    y = mg.grouped_gemm(h, meta, wd, wd, 1, True)
    out = mg.combine(y, pos, gates)
    torch.cuda.synchronize()
    assert build.LAUNCHES["moe_grouped"] == 5
    want_pos, want_meta = mg.dispatch_plain(ids, E, mg.WGMMA_ROWS)
    assert torch.equal(pos, want_pos) and torch.equal(meta, want_meta)
    assert int(meta[E - 1]) == int(meta[E]) == T * k     # empty experts
    assert torch.equal(xs, mg.gather_plain(x, want_pos, k))
    want_h, want_y = mg.ffn_plain(xs, want_meta, wg, wu, wd)
    torch.testing.assert_close(h.float(), want_h.float(), **GROUPED_BF16_TOL)
    torch.testing.assert_close(y.float(), want_y.float(), **GROUPED_BF16_TOL)
    # the down product of the kernel's own h: only the summing order differs
    bounds = want_meta[:E + 1].tolist()
    y_of_h = torch.zeros_like(y)
    for e in range(E):
        y_of_h[bounds[e]:bounds[e + 1]] = h[bounds[e]:bounds[e + 1]] @ wd[e]
    err = (y.float() - y_of_h.float()).abs()
    assert float(err.mean()) < 1e-3 * float(y_of_h.float().abs().mean()) \
        + 1e-6
    assert torch.equal(out, mg.combine_plain(y, pos, gates))
    want = mg.moe_grouped_plain(x, gates, ids, wg, wu, wd)
    torch.testing.assert_close(out.float(), want.float(), **GROUPED_BF16_TOL)
    assert float((out.float() - want.float()).abs().mean()) \
        < 1e-2 * float(want.float().abs().mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_simt_matches_plain(cuda, dtype):
    """Widths that are not whole tiles, and f32, take the SIMT products:
    against the plain version on the card, f32 to 1e-5 of the largest
    output (TF32 off), bf16 within ``GROUPED_BF16_TOL``."""
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.kernels import ops
    E, k, d, f, T = 6, 2, 72, 40, 37
    args = _grouped_inputs(E, k, d, f, T, dtype, cuda, seed=3)
    assert not mg.uses_wgmma(dtype, d, f)
    build.reset_launches()
    got = ops.moe_grouped(*args)
    assert build.LAUNCHES["moe_grouped"] == 5
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = mg.moe_grouped_plain(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    if dtype == torch.float32:
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   **GROUPED_BF16_TOL)
    # the dispatch at one token and with every token on one expert
    for ids in (args[2][:1], torch.zeros_like(args[2][:, :1])):
        for bm in (mg.SIMT_ROWS, mg.WGMMA_ROWS):
            got_d = mg.dispatch(ids.contiguous(), E, bm)
            want_d = mg.dispatch_plain(ids, E, bm)
            assert all(map(torch.equal, got_d, want_d))


def test_moe_grouped_layer_has_no_host_sync(cuda):
    """``models/moe.moe_grouped`` (router, dispatch, products, combine) on
    an olmoe-width layer runs under sync-debug "error": nothing of it
    reads the device back to the host."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as me
    cfg = get_config("olmoe-1b-7b")
    g = torch.Generator(device=cuda).manual_seed(5)
    p = {name: (torch.randn(spec.shape, generator=g, device=cuda)
                / spec.shape[-2] ** 0.5).to(spec.dtype)
         for name, spec in me.moe_schema(cfg).items()}
    x = torch.randn(1, 512, cfg.d_model, generator=g,
                    device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    build.reset_launches()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = me.moe(p, x, cfg, impl="grouped")
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert build.LAUNCHES["moe_grouped"] == 5
    dense = me.moe_dense(p, x, cfg)
    assert float((out.float() - dense.float()).abs().mean()) \
        < 1e-2 * float(dense.float().abs().mean())


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "jamba_v0p1_52b"])
def test_prefill_grouped_launches_per_moe_layer(cuda, arch):
    """A bf16 prefill with ``moe_impl="grouped"`` launches the grouped
    FFN's five kernels once in every MoE layer, and its logits stay with
    the dense prefill's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    cfg = get_smoke_config(arch)
    params = sc.init(tf.schema(cfg), torch.Generator(
        device=cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (1, 64))).to(cuda)
    moe_layers = cfg.n_superblocks * sum(
        f == "moe" for _, f in tf.layer_kinds(cfg))
    build.reset_launches()
    got, _ = tf.prefill(params, cfg, toks, 16, 63, moe_impl="grouped")
    assert build.LAUNCHES["moe_grouped"] == 5 * moe_layers > 0
    build.reset_launches()
    want, _ = tf.prefill(params, cfg, toks, 16, 63)
    assert build.LAUNCHES["moe_grouped"] == 0
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
