"""The port's plain read path and scatter held to the JAX reference on the
reference store's own exported snapshot: fused GET/SCAN (both
``lb_fraction``s, at the snapshot's read version and at older ones that
walk MVCC chains), the staged reference path, delta application with the
cache tier, and the row scatter.  Inputs cross as numpy; integer results
must be exactly equal."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HoneycombConfig as JConfig
from repro.core import read_path as jrp
from repro.core.shard import StoreShard as JShard
from repro.kernels import delta_scatter as jds
from repro.kernels import ref as jref
from repro_torch.core import HoneycombConfig as TConfig
from repro_torch.core import read_path as trp
from repro_torch.core.keys import int_key, pack_keys
from repro_torch.kernels import delta_scatter as tds
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

GEOM = dict(node_cap=16, log_cap=4, n_shortcuts=4, cache_slots=32,
            max_scan_leaves=2, max_scan_items=16, max_height=6)
JCFG, TCFG = JConfig(**GEOM), TConfig(**GEOM)
N_ITEMS = 300
# the reference oracles, compiled once per shape instead of run op by op
_STATIC = ("cfg", "lb_fraction")
J_GET = jax.jit(jref.batched_get_fused_ref, static_argnames=_STATIC)
J_SCAN = jax.jit(jref.batched_scan_fused_ref, static_argnames=_STATIC)


@functools.lru_cache(maxsize=None)
def _reference_snapshot():
    s = JShard(JCFG, heap_capacity=512)
    rng = np.random.default_rng(0)
    for i in rng.permutation(N_ITEMS):
        s.put(int_key(int(i)), b"v%06d" % i)
    for i in range(0, N_ITEMS, 7):
        s.update(int_key(i), b"u%06d" % i)
    for i in range(0, N_ITEMS, 13):
        s.delete(int_key(i))
    for i in range(0, N_ITEMS, 5):     # leaves with live log entries
        s.update(int_key(i), b"w%d" % i)
    return s.export_snapshot()


def _snapshots(back: int):
    """(reference, port) snapshots at ``back`` versions before the
    exported read version, cache tier attached on both sides."""
    js = _reference_snapshot()
    rv = max(int(js.read_version) - back, 0)
    js = jrp.attach_cache_image(js._replace(read_version=jnp.int32(rv)),
                                JCFG)
    ts = trp.TreeSnapshot(
        image=torch.from_numpy(np.asarray(js.image).view(np.int32).copy()),
        pagetable=torch.from_numpy(np.asarray(js.pagetable).copy()),
        root_lid=int(js.root_lid), read_version=rv,
        cache_lids=torch.from_numpy(np.asarray(js.cache_lids).copy()))
    return js, trp.attach_cache_image(ts, TCFG)


def _keys(keys):
    lanes, lens = pack_keys(keys, TCFG.key_words)
    return ((jnp.asarray(lanes), jnp.asarray(lens)),
            (torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(lens)))


def _assert_same(want, got):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _scan_inputs():
    rng = np.random.default_rng(4)
    los = rng.integers(0, N_ITEMS + 20, 48)
    widths = rng.choice([0, 2, 9, 60], 48)
    return ([int_key(int(x)) for x in los],
            [int_key(int(x + w)) for x, w in zip(los, widths)])


@pytest.mark.parametrize("back", [0, 30, 200])
def test_cache_tier_matches_reference(back):
    js, ts = _snapshots(back)
    _assert_same(js.cache_image, ts.cache_image)
    _assert_same(js.image, ts.image)


@pytest.mark.parametrize("back", [0, 30, 200])
@pytest.mark.parametrize("lb_fraction", [0.0, 0.25])
def test_fused_get_plain_matches_reference(lb_fraction, back):
    js, ts = _snapshots(back)
    keys = [int_key(int(i)) for i in
            np.random.default_rng(3).integers(0, N_ITEMS + 30, 64)]
    (jk, jl), (tk, tl) = _keys(keys)
    want, wm = J_GET(js, jk, jl, cfg=JCFG, lb_fraction=lb_fraction)
    got, gm = tops.batched_get_fused(ts, tk, tl, cfg=TCFG,
                                     lb_fraction=lb_fraction)
    _assert_same(tuple(want), tuple(got))
    _assert_same(wm, gm)


@pytest.mark.parametrize("back", [0, 30, 200])
@pytest.mark.parametrize("lb_fraction", [0.0, 0.25])
def test_fused_scan_plain_matches_reference(lb_fraction, back):
    js, ts = _snapshots(back)
    los, his = _scan_inputs()
    (jlo, jll), (tlo, tll) = _keys(los)
    (jhi, jhl), (thi, thl) = _keys(his)
    want, wm = J_SCAN(js, jlo, jll, jhi, jhl, cfg=JCFG,
                      lb_fraction=lb_fraction)
    got, gm = tops.batched_scan_fused(ts, tlo, tll, thi, thl, cfg=TCFG,
                                      lb_fraction=lb_fraction)
    _assert_same(tuple(want), tuple(got))
    _assert_same(wm, gm)
    assert bool(got.truncated.any()) and int(got.count.max()) > 1


def _scalar_walk(ts, lo, lolen, hi, hilen, b, lb_fraction):
    """Request ``b`` of a fused SCAN walked one row at a time: the set of
    rows it reads in the combined cache+heap view and its count of
    dependent row reads, counted as the fused kernel counts them (a cached
    level one; a heap level or a sibling leaf one, plus one per
    old-version hop)."""
    cfg, view = TCFG, trp.fused_view(ts, TCFG)
    S, n = ts.image.shape[0], ts.image.shape[0] + ts.cache_image.shape[0]
    clids = ts.cache_lids.tolist()
    rows, loads = set(), 0
    one = slice(b, b + 1)

    def heap_row(lid):
        nonlocal loads
        loads += 1
        p = int(view.pagetable[lid])
        for _ in range(cfg.max_version_chain):
            rows.add(p % n)
            old = int(view.oldptr[p])
            if not (int(view.version[p]) > ts.read_version and old != -1):
                break
            p, loads = old, loads + 1
        rows.add(p % n)
        return p

    def items(p):                     # the live (key, klen, ...) of leaf p
        keys, kl, _, _, live = trp._resolve_leaf(view, torch.tensor([p]),
                                                 cfg)
        return keys[0][live[0]], kl[0][live[0]]

    def cmp(keys, kl, q, ql):         # each item against the query
        return trp.torch_key_cmp(keys, kl, q[one].expand(len(kl), -1),
                                 ql[one].expand(len(kl)))

    routed = (b % 16) < round(lb_fraction * 16)
    lid = ts.root_lid
    for _ in range(cfg.max_height):
        if lid in clids and lid != -1 and not routed:
            p = S + clids.index(lid)
            rows.add(p)
            loads += 1
        else:
            p = heap_row(lid)
        if int(view.ntype[p]) == 1:   # LEAF
            break
        lid = int(trp._child(view, torch.tensor([p]), lo[one], lolen[one],
                             cfg)[0])
    leaf = p
    floor = None                      # floor pre-pass: walk left
    for _ in range(cfg.max_scan_leaves):
        keys, kl = items(p)
        leq = cmp(keys, kl, lo, lolen) <= 0
        if bool(leq.any()):
            i = int(torch.nonzero(leq)[-1, 0])
            floor = (keys[i:i + 1], kl[i:i + 1])
            break
        if int(view.lsib[p]) == -1:
            break
        p = heap_row(max(int(view.lsib[p]), 0))
    count = int(floor is not None and int(cmp(*floor, hi, hilen)[0]) <= 0)
    p, done = leaf, False             # forward scan: walk right
    for _ in range(cfg.max_scan_leaves):
        keys, kl = items(p)
        c_hi = cmp(keys, kl, hi, hilen)
        emitted = int(((c_hi <= 0) & (cmp(keys, kl, lo, lolen) > 0)).sum())
        trunc = emitted > cfg.max_scan_items - count
        count += min(emitted, cfg.max_scan_items - count)
        done = bool((c_hi > 0).any()) or int(view.rsib[p]) == -1 or trunc
        if done:
            break
        p = heap_row(max(int(view.rsib[p]), 0))
    return rows, loads


@pytest.mark.parametrize("back", [0, 30, 200])
@pytest.mark.parametrize("lb_fraction", [0.0, 0.25])
def test_fused_row_trace_matches_a_scalar_walk(lb_fraction, back):
    """The plain fused SCAN's ``touched`` and ``loads`` (what the kernel
    must write into them) equal a row-at-a-time walk of each request,
    through cached and routed levels, MVCC hops and sibling leaves; the
    results are those of an untraced call."""
    _, ts = _snapshots(back)
    los, his = _scan_inputs()
    # deleted keys: where one was a leaf's first key, the floor pre-pass
    # walks left
    los += [int_key(i) for i in range(0, N_ITEMS, 13)]
    his += [int_key(i + 5) for i in range(0, N_ITEMS, 13)]
    (_, (lo, lolen)), (_, (hi, hilen)) = _keys(los), _keys(his)
    n = ts.image.shape[0] + ts.cache_image.shape[0]
    touched = torch.zeros(n, dtype=torch.int32)
    loads = torch.zeros(len(los), dtype=torch.int32)
    kw = dict(cfg=TCFG, lb_fraction=lb_fraction)
    got, gm = tref.batched_scan_fused_ref(ts, lo, lolen, hi, hilen, **kw,
                                          touched=touched, loads=loads)
    want, wm = tref.batched_scan_fused_ref(ts, lo, lolen, hi, hilen, **kw)
    for a, b in zip(want + (wm,), got + (gm,)):
        assert torch.equal(a, b)
    rows = set()
    for b in range(len(los)):
        r, n_loads = _scalar_walk(ts, lo, lolen, hi, hilen, b, lb_fraction)
        assert int(loads[b]) == n_loads, b
        rows |= r
    assert set(torch.nonzero(touched)[:, 0].tolist()) == rows
    assert int(touched.max()) == 1 and int(loads.max()) > int(loads.min())


@pytest.mark.parametrize("op", ["get", "scan"])
def test_reference_backend_matches_reference(op):
    js, ts = _snapshots(0)
    los, his = _scan_inputs()
    (jlo, jll), (tlo, tll) = _keys(los)
    if op == "get":
        want = jax.jit(jrp.batched_get, static_argnames="cfg")(
            js, jlo, jll, cfg=JCFG)
        got = trp.batched_get(ts, tlo, tll, TCFG)
    else:
        (jhi, jhl), (thi, thl) = _keys(his)
        want = jax.jit(jrp.batched_scan, static_argnames="cfg")(
            js, jlo, jll, jhi, jhl, cfg=JCFG)
        got = trp.batched_scan(ts, tlo, tll, thi, thl, TCFG)
    _assert_same(tuple(want), tuple(got))


def test_log_sort_positions_match_reference():
    rng = np.random.default_rng(5)
    B, L = 64, 16
    nlog = rng.integers(0, L + 1, B).astype(np.int32)
    hints = np.zeros((B, L), np.int32)
    for b in range(B):            # hint j = rank among the j entries before
        for j in range(L):
            hints[b, j] = rng.integers(0, j + 1)
    want = jrp.log_sort_positions(jnp.asarray(hints), jnp.asarray(nlog), L)
    got = trp.log_sort_positions(torch.from_numpy(hints),
                                 torch.from_numpy(nlog), L)
    _assert_same(want, got)


def test_apply_delta_matches_reference():
    """A packed delta (dirty rows with padded repeats, page-table commands,
    a new cache frontier) applied by both packages gives the same
    snapshot, cache tier included."""
    js, ts = _snapshots(0)
    rng = np.random.default_rng(6)
    S, IW = ts.image.shape
    rows = np.sort(rng.choice(S, 20, replace=False)).astype(np.int32)
    rows = np.concatenate([rows, np.full(12, rows[-1], np.int32)])
    img = np.asarray(js.image)[rng.integers(0, S, 32)]
    img[20:] = img[19]
    lids = np.array([1, 4, 4], np.int32)
    phys = np.asarray(js.pagetable)[[2, 3, 3]]
    clids = np.asarray(js.cache_lids)[::-1].copy()
    jd = jrp.SnapshotDelta(
        rows=jnp.asarray(rows), image=jnp.asarray(img),
        pt_lids=jnp.asarray(lids), pt_phys=jnp.asarray(phys),
        root_lid=js.root_lid, read_version=js.read_version,
        cache_lids=jnp.asarray(clids))
    td = trp.SnapshotDelta(
        rows=torch.from_numpy(rows), image=torch.from_numpy(img.view(np.int32)),
        pt_lids=torch.from_numpy(lids), pt_phys=torch.from_numpy(phys),
        root_lid=ts.root_lid, read_version=ts.read_version,
        cache_lids=torch.from_numpy(clids))
    want = jrp.apply_snapshot_delta(js, jd, cfg=JCFG)
    before = ts.image.clone()
    got = trp.apply_snapshot_delta(ts, td, cfg=TCFG)
    for f in ("image", "pagetable", "cache_lids", "cache_image"):
        _assert_same(getattr(want, f), getattr(got, f))
    assert torch.equal(ts.image, before)      # the base snapshot is intact


def test_plain_scatter_matches_reference_kernel():
    rng = np.random.default_rng(7)
    S, W, D = 40, 1273, 16
    image = rng.integers(0, 2 ** 32, (S, W), dtype=np.uint32)
    rows = rng.choice(S, D, replace=False).astype(np.int32)
    rows[-4:] = rows[-5]
    upd = rng.integers(0, 2 ** 32, (D, W), dtype=np.uint32)
    upd[-4:] = upd[-5]
    want_k = jds.snapshot_image_scatter(jnp.asarray(image), jnp.asarray(rows),
                                        jnp.asarray(upd), interpret=True)
    want_r = jref.snapshot_image_scatter_ref(jnp.asarray(image),
                                             jnp.asarray(rows),
                                             jnp.asarray(upd))
    got = tops.snapshot_image_scatter(
        torch.from_numpy(image.view(np.int32).copy()),
        torch.from_numpy(rows), torch.from_numpy(upd.view(np.int32)))
    _assert_same(want_k, got)
    _assert_same(want_r, got)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the dispatch runs the plain version; the kernel
    wrapper itself only takes CUDA tensors and never falls back."""
    image = torch.zeros(4, 8, dtype=torch.int32)
    rows = torch.zeros(1, dtype=torch.int32)
    upd = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tds.snapshot_image_scatter(image, rows, upd)
    assert int(tops.snapshot_image_scatter(image, rows, upd)[0, 0]) == 1
    with pytest.raises(ValueError):
        tops.snapshot_image_scatter(image.to("meta"), rows, upd)
    assert tref.snapshot_delta_scatter_ref is not None


@pytest.mark.parametrize("op", ["get", "scan"])
def test_fused_read_refuses_a_snapshot_without_cache_tier(op):
    """The fused read serves only a snapshot with its cache tier; it never
    turns into the staged reference path."""
    _, ts = _snapshots(0)
    los, his = _scan_inputs()
    _, (tlo, tll) = _keys(los)
    _, (thi, thl) = _keys(his)
    for bare in (ts._replace(cache_image=None),
                 ts._replace(cache_lids=None, cache_image=None)):
        with pytest.raises(ValueError, match="cache tier"):
            if op == "get":
                tops.batched_get_fused(bare, tlo, tll, cfg=TCFG)
            else:
                tops.batched_scan_fused(bare, tlo, tll, thi, thl, cfg=TCFG)


@pytest.mark.parametrize("bad", [4, -5, 100])
def test_plain_scatter_rejects_rows_out_of_range(bad):
    """A row outside [-S, S) raises before anything is written; -1 wraps
    to the last row.  The kernel's wrapper does the same on the card."""
    image = torch.zeros(4, 8, dtype=torch.int32)
    upd = torch.ones(2, 8, dtype=torch.int32)
    with pytest.raises(IndexError):
        tops.snapshot_image_scatter(image, torch.tensor([1, bad],
                                                        dtype=torch.int32), upd)
    assert not image.any()
    tops.snapshot_image_scatter(image, torch.tensor([1, -1], dtype=torch.int32),
                                upd)
    assert image[[1, 3]].eq(1).all() and not image[[0, 2]].any()
