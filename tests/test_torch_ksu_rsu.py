"""The port's KSU floor search (plain and over packed node images) and RSU
leaf merge held to the JAX reference: the plain versions the port runs on
the CPU against the reference's ``ref`` oracles and its Pallas kernels in
interpret mode, on the reference's own sweeps and on u32 lanes across the
whole range; then against the port's own read path on a live store, the
invariants ``chip_smoke.py`` checks on the card.  Inputs cross as numpy;
every output is int32 and must be exactly equal."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: breaks an import cycle)
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import HoneycombConfig, HoneycombStore, NodeImageLayout
from repro_torch.core import read_path as trp
from repro_torch.core.heap import LEAF
from repro_torch.core.keys import int_key, pack_keys
from repro_torch.kernels import ops as tops
from test_torch_cuda import _image_case, _merge_case, _search_case


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy u32/i32 -> the port's int32 (bit view) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("B,N,KW,lane_hi", [
    (8, 16, 4, 60), (128, 64, 8, 60), (50, 8, 2, 60), (3, 80, 8, 60),
    (64, 64, 8, 2 ** 32), (40, 8, 8, 2 ** 32)])
def test_key_search_matches_reference(B, N, KW, lane_hi):
    q, qlen, keys, klens, valid = _search_case(B, N, KW, B + N, lane_hi)
    got = tops.key_search(*map(_t, (q, qlen, keys, klens, valid)))
    want = jref.key_search_ref(*map(jnp.asarray, (q, qlen, keys, klens,
                                                  valid)))
    interp = jops.key_search(q, qlen, keys, klens, valid,
                             backend="interpret", block_b=16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(interp))
    if lane_hi > 2 ** 31:       # the high lanes really decide some floors
        assert (keys >= 2 ** 31).any() and (got.numpy() >= 0).sum() > B // 4


@pytest.mark.parametrize("cfg,block,count_top_bit", [
    pytest.param(HoneycombConfig(node_cap=16, log_cap=4, n_shortcuts=4),
                 "sorted", top, id=str(top)) for top in (False, True)] + [
    pytest.param(HoneycombConfig(), block, top, id=f"default-{block}-{top}")
    for block in ("sorted", "shortcut") for top in (False, True)])
def test_key_search_image_matches_reference(cfg, block, count_top_bit):
    """The 16-item geometry's sorted block, and the paper's default
    geometry's sorted (64 keys) and shortcut (8 keys) blocks."""
    q, qlen, img, kwargs = _image_case(cfg, 24, 3, count_top_bit, block)
    got = tops.key_search_image(_t(q), _t(qlen), _t(img), **kwargs).numpy()
    want = jops.key_search_image(*map(jnp.asarray, (q, qlen, img)),
                                 backend="ref", **kwargs)
    interp = jops.key_search_image(*map(jnp.asarray, (q, qlen, img)),
                                   backend="interpret", **kwargs)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(interp))
    assert got.max() >= 0                   # some floors actually found
    if count_top_bit:
        assert (got[1::2] == -1).all() and (got[0::2] >= 0).any()


@pytest.mark.parametrize("B,N,L", [(4, 8, 4), (64, 64, 16), (33, 16, 8)])
def test_leaf_merge_matches_reference(B, N, L):
    args = _merge_case(B, N, L, B)
    perm, valid = tops.leaf_merge(*map(_t, args), node_cap=N, log_cap=L)
    wp, wv = jref.leaf_merge_ref(*map(jnp.asarray, args), node_cap=N,
                                 log_cap=L)
    ip, iv = jops.leaf_merge(*args, node_cap=N, log_cap=L,
                             backend="interpret", block_b=16)
    assert perm.shape == (B, N + L) and perm.dtype == valid.dtype == \
        torch.int32
    # every one of the T positions, the unused tail included
    for p, v in ((wp, wv), (ip, iv)):
        np.testing.assert_array_equal(perm.numpy(), np.asarray(p))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(v))
    assert (args[1] > 0).any() and (args[0] > 0).any()


def test_empty_batches():
    """B = 0 gives empty results of the right shapes and types."""
    e1 = torch.zeros(0, dtype=torch.int32)
    got = tops.key_search(torch.zeros(0, 8, dtype=torch.int32), e1,
                          torch.zeros(0, 64, 8, dtype=torch.int32),
                          *(torch.zeros(0, 64, dtype=torch.int32),) * 2)
    assert got.shape == (0,) and got.dtype == torch.int32
    img = torch.zeros(0, 300, dtype=torch.int32)
    got = tops.key_search_image(torch.zeros(0, 8, dtype=torch.int32), e1,
                                img, keys_off=10, lens_off=200,
                                count_off=1, n_keys=16, key_words=8)
    assert got.shape == (0,) and got.dtype == torch.int32
    perm, valid = tops.leaf_merge(e1, e1, *(torch.zeros(0, 16, dtype=torch
                                                        .int32),) * 2,
                                  node_cap=64, log_cap=16)
    assert perm.shape == valid.shape == (0, 80)
    assert perm.dtype == valid.dtype == torch.int32


def test_key_search_matches_store_search():
    """Twin of tests/test_kernels.py:test_kernels_match_store_search: the
    floor search over the port's own store's root finds each query
    between two keys at its left neighbour."""
    cfg = HoneycombConfig(node_cap=16, log_cap=4, n_shortcuts=4)
    store = HoneycombStore(cfg, heap_capacity=64, device="cpu")
    for i in range(16):
        store.put(int_key(i * 2), b"v")
    snap = trp.snapshot_fields(store.export_snapshot(), cfg)
    phys = int(snap.pagetable[snap.root_lid])
    B = 8
    lanes, lens = pack_keys([int_key(2 * i + 1) for i in range(B)],
                            cfg.key_words)
    keys = snap.skeys[phys][None].expand(B, -1, -1).contiguous()
    klens = snap.skeylen[phys][None].expand(B, -1).contiguous()
    valid = (torch.arange(cfg.node_cap) < snap.nitems[phys]) \
        .to(torch.int32)[None].expand(B, -1).contiguous()
    idx = tops.key_search(_t(lanes), _t(lens), keys, klens, valid)
    np.testing.assert_array_equal(idx.numpy(), np.arange(B))


def _live_store(n=1 << 12, writes=600, seed=0):
    """A CPU store at the paper's geometry after mixed writes: updates,
    deletes and inserts between existing keys, so that leaves carry log
    entries."""
    cfg = HoneycombConfig()
    rng = np.random.default_rng(seed)
    store = HoneycombStore(cfg, device="cpu")
    for i in rng.permutation(n):
        store.put(int_key(int(i)), b"v%d" % i)
    store.export_snapshot()
    for op, i in zip(rng.choice(3, writes, p=[0.6, 0.2, 0.2]),
                     rng.integers(0, n, writes)):
        k = int_key(int(i))
        if op == 0:
            store.update(k, b"u%d" % i)
        elif op == 1:
            store.delete(k)
        else:
            store.put(k + b"\x01", b"p%d" % i)
    return cfg, store, store.export_snapshot()


def test_ksu_matches_read_path_on_a_live_store():
    """(b) the shortcut-block search, clamped at 0, is the read path's
    ``_shortcut_floor``; (c) the one-stage search over the whole sorted
    block is its two-stage ``_segment_floor(_shortcut_floor)``; and the
    block-mode search equals the image-mode one: at every level every
    request of a GET batch visits."""
    cfg, store, snap = _live_store()
    view = trp.snapshot_fields(snap, cfg)
    offs = NodeImageLayout.for_config(cfg).offsets()
    N, KW = cfg.node_cap, cfg.key_words
    rng = np.random.default_rng(1)
    n = 1 << 12
    keys = [int_key(int(x)) for x in rng.integers(0, n + n // 4, 256)]
    lanes, lens = pack_keys(keys, KW)
    key, klen = _t(lanes), _t(lens)
    B = len(keys)
    lid = torch.full((B,), snap.root_lid, dtype=torch.int32)
    phys = torch.zeros_like(lid)
    done = torch.zeros(B, dtype=torch.bool)
    levels, nonzero = 0, 0
    for _ in range(cfg.max_height):
        cur = trp._resolve_version(view, view.pagetable[lid],
                                   snap.read_version, cfg)
        cur = torch.where(done, phys, cur)
        rows = snap.image[cur]
        sc = tops.key_search_image(
            key, klen, rows, keys_off=offs["sc_keys"][0],
            lens_off=offs["sc_keylen"][0], count_off=offs["n_shortcuts"][0],
            n_keys=cfg.n_shortcuts, key_words=KW)
        sb = tops.key_search_image(
            key, klen, rows, keys_off=offs["skeys"][0],
            lens_off=offs["skeylen"][0], count_off=offs["nitems"][0],
            n_keys=N, key_words=KW)
        seg = trp._shortcut_floor(view, cur, key, klen)
        assert torch.equal(sc.clamp(min=0), seg)
        assert torch.equal(sb, trp._segment_floor(view, cur, seg, key, klen,
                                                  cfg))
        sk = offs["skeys"][0]
        blocks = rows[:, sk:sk + N * KW].reshape(B, N, KW)
        sl = offs["skeylen"][0]
        valid = (torch.arange(N)[None, :]
                 < rows[:, offs["nitems"][0]][:, None]).to(torch.int32)
        assert torch.equal(tops.key_search(key, klen, blocks,
                                           rows[:, sl:sl + N], valid), sb)
        nonzero += int((sb != 0).sum())
        levels += 1
        is_leaf = view.ntype[cur] == LEAF
        child = trp._child(view, cur, key, klen, cfg)
        done_next = done | is_leaf
        lid = torch.where(done_next, lid, child)
        phys, done = cur, done_next
        if bool(done.all()):
            break
    assert levels >= 2 and bool(done.all()) and nonzero > 0


def test_rsu_matches_read_path_on_a_live_store():
    """(e) over every leaf row of the live image: the merge's ``perm``
    is, in all T positions, the stable order of the ranks the read path's
    leaf resolve builds, and ``valid`` is its used-slot mask."""
    cfg, store, snap = _live_store(seed=2)
    view = trp.snapshot_fields(snap, cfg)
    leaves = (view.ntype == LEAF).nonzero()[:, 0].to(torch.int32)
    perm, valid = tops.leaf_merge(
        view.nitems[leaves], view.nlog[leaves], view.log_backptr[leaves],
        view.log_hint[leaves], node_cap=cfg.node_cap, log_cap=cfg.log_cap)
    rank, used = trp.leaf_ranks(
        view.nitems[leaves], view.nlog[leaves], view.log_backptr[leaves],
        view.log_hint[leaves], cfg.node_cap, cfg.log_cap)
    assert torch.equal(perm, torch.argsort(rank, dim=1, stable=True)
                       .to(torch.int32))
    assert torch.equal(valid, used.to(torch.int32))
    assert int((view.nlog[leaves] > 0).sum()) > 0
