"""The port's CPU baseline store, byte model and key helpers against the
reference's.

``repro_torch.baselines.CpuOrderedStore`` and
``repro.baselines.cpu_store.CpuOrderedStore`` take the same seeded op
streams (puts, updates, deletes, gets, scans with and without
``max_items``) at node capacities 4, 16 and 64: every answer, every
``CpuStoreStats`` field after every op, the leaves' keys at the end and
the port's maintained list of leaf minimums (against the reference's
rebuilt ``_mins``) after every op must be equal.  The streams start on an
empty store, empty the first leaf and a middle leaf by deletes, write
and read keys below every stored key, and mix key lengths.  Then the
port's baseline against the port's ``HoneycombStore`` (the twin of
tests/test_system.py's agreement test), the byte model and
``DEFAULT_CONFIG``, and the host and torch key helpers against the
reference's numpy and jax ones."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import cpu_store as jcpu
from repro.core import config as jconfig
from repro.core import keys as jkeys
from repro_torch import baselines as tcpu
from repro_torch.core import DEFAULT_CONFIG, HoneycombConfig, HoneycombStore
from repro_torch.core import keys as tkeys
from repro_torch.core.keys import int_key
from test_torch_store import SMALL

BYTE_MODEL = ("header_bytes", "shortcut_bytes", "segment_bytes",
              "log_bytes", "node_bytes")


class _Both:
    """One op stream through both stores; every read's answers and, after
    every op, the stats and the leaf minimums must be equal."""

    def __init__(self, node_cap):
        self.j = jcpu.CpuOrderedStore(node_cap=node_cap)
        self.t = tcpu.CpuOrderedStore(node_cap=node_cap)

    def __call__(self, op, *args):
        want = getattr(self.j, op)(*args)
        got = getattr(self.t, op)(*args)
        assert got == want, (op, args)
        assert dataclasses.asdict(self.t.stats) \
            == dataclasses.asdict(self.j.stats), (op, args)
        assert self.t._mins == self.j._mins, (op, args)
        return got

    def leaf_keys(self):
        return [list(lf.keys) for lf in self.t.leaves]


def _key(rng) -> bytes:
    """A key of 1-12 bytes over a small alphabet: lengths mix, prefixes
    and repeats are common."""
    n = int(rng.integers(1, 13))
    return bytes(rng.choice(np.frombuffer(b"\x00\x01abz\xff", np.uint8), n))


def _reads(b: _Both, rng, keys: list[bytes], n: int):
    for _ in range(n):
        k = keys[int(rng.integers(len(keys)))] if keys and rng.random() < 0.7 \
            else _key(rng)
        b("get", k)
        lo, hi = sorted((_key(rng), _key(rng)))
        b("scan", lo, hi)
        b("scan", lo, hi, int(rng.integers(1, 6)))
    b("get_batch", keys[:20] + [b"", b"\x00"])
    b("scan_batch", [(b"", b"\xff" * 3), (b"a", b"b"), (b"z\xff", b"\xff")])


@pytest.mark.parametrize("node_cap", [4, 16, 64])
def test_baseline_matches_reference(node_cap):
    rng = np.random.default_rng(node_cap)
    b = _Both(node_cap)
    # an empty store: reads, a delete of nothing, a scan over everything
    b("get", b"a")
    b("scan", b"", b"\xff" * 8)
    b("scan", b"m", b"z", 3)
    b("delete", b"a")
    # a load, in random order, of keys of several lengths
    keys = sorted({_key(rng) for _ in range(40 * node_cap)})
    for i in rng.permutation(len(keys)):
        b("put", keys[i], b"v%d" % i)
    assert len(b.t.leaves) >= 4
    _reads(b, rng, keys, 30)
    # deletes that empty the first leaf, then a middle leaf
    for k in list(b.j.leaves[0].keys):
        b("delete", k)
    mid = len(b.j.leaves) // 2
    for k in list(b.j.leaves[mid].keys)[::-1]:
        b("delete", k)
    _reads(b, rng, keys, 10)
    # keys below every stored key (position 0 of the first leaf)
    low = min(k for lf in b.j.leaves for k in lf.keys)
    for k in (b"", low[:-1], low[:-1] + b"\x00"):
        if k < low:
            b("put", k, b"low")
            b("get", k)
            b("scan", k, low)
    b("scan", b"", b"")
    # a seeded mix of every op
    for _ in range(30 * node_cap):
        k = keys[int(rng.integers(len(keys)))] if rng.random() < 0.8 \
            else _key(rng)
        r = rng.random()
        if r < 0.3:
            b("put", k, bytes(rng.integers(65, 91, int(rng.integers(0, 20)),
                                           dtype=np.uint8)))
        elif r < 0.45:
            b("update", k, b"u")
        elif r < 0.7:
            b("delete", k)
        elif r < 0.85:
            b("get", k)
        else:
            lo, hi = sorted((k, _key(rng)))
            b("scan", lo, hi, int(rng.integers(1, 8))
              if rng.random() < 0.5 else None)
    _reads(b, rng, keys, 10)
    # delete every key: the store is one empty leaf again
    for lf in list(b.j.leaves):
        for k in list(lf.keys):
            b("delete", k)
    assert b.t._mins == [b""] and len(b.t.leaves) == 1
    _reads(b, rng, keys, 3)
    assert b.leaf_keys() == [list(lf.keys) for lf in b.j.leaves]
    # the chain of next pointers walks the same leaves in order
    node, chain = b.t.leaves[0], []
    while node is not None:
        chain.append(node)
        node = node.next
    assert chain == b.t.leaves


def test_baseline_leaves_match_reference_after_load():
    """A bulk load with splits everywhere: equal leaves, chains and
    minimums, and the lookups' node visits still one per op."""
    b = _Both(8)
    rng = np.random.default_rng(3)
    for i in rng.permutation(3000):
        b("put", int_key(int(i), 4), b"x%d" % i)
    assert b.leaf_keys() == [list(lf.keys) for lf in b.j.leaves]
    assert b.t.stats.node_visits == 3000
    assert b.t._mins == [lf.keys[0] for lf in b.t.leaves]


def test_baseline_collect_matches_reference():
    b = _Both(16)
    for i in range(100):
        b("put", int_key(i), b"v")
    b("get", int_key(5))
    b("scan", int_key(3), int_key(40))
    b("delete", int_key(7))
    got = [(s.name, s.kind, s.value, s.labels) for s in b.t.stats.collect()]
    want = [(s.name, s.kind, s.value, s.labels) for s in b.j.stats.collect()]
    assert got == want
    assert {n for n, *_ in got} == {
        "cpu_store_" + f.name for f in dataclasses.fields(tcpu.CpuStoreStats)}


def test_honeycomb_vs_cpu_baseline_agree():
    """The port's HoneycombStore on the CPU and the port's baseline are
    observationally equivalent (same results; different cost profiles)."""
    hc = HoneycombStore(HoneycombConfig(node_cap=16, log_cap=4,
                                        n_shortcuts=4), device="cpu")
    cp = tcpu.CpuOrderedStore(node_cap=16)
    rng = np.random.default_rng(1)
    for _ in range(800):
        k = int_key(int(rng.integers(0, 200)))
        if rng.random() < 0.7:
            v = bytes(rng.integers(65, 91, 8))
            hc.put(k, v)
            cp.put(k, v)
        else:
            hc.delete(k)
            cp.delete(k)
    keys = [int_key(i) for i in range(200)]
    assert hc.get_batch(keys) == cp.get_batch(keys)
    ranges = [(int_key(a), int_key(a + 5)) for a in range(0, 190, 17)]
    assert hc.scan_batch(ranges) == cp.scan_batch(ranges)


@pytest.mark.parametrize("geometry", [
    {}, SMALL, dict(key_words=4, val_words=2),
    dict(key_words=16, val_words=8, node_cap=32, n_shortcuts=8, log_cap=8)],
    ids=["default", "small", "kw4_vw2", "kw16_vw8"])
def test_byte_model_matches_reference(geometry):
    j, t = jconfig.HoneycombConfig(**geometry), HoneycombConfig(**geometry)
    assert {p: getattr(t, p) for p in BYTE_MODEL} \
        == {p: getattr(j, p) for p in BYTE_MODEL}
    assert all(getattr(t, p) > 0 for p in BYTE_MODEL)


def test_default_config_matches_reference():
    assert isinstance(DEFAULT_CONFIG, HoneycombConfig)
    assert DEFAULT_CONFIG == HoneycombConfig()
    # every field of the port's config equals the reference's, key for
    # key and in order (split_fill and gc_batch too, which no code of
    # either package reads)
    want = dataclasses.asdict(jconfig.DEFAULT_CONFIG)
    assert list(dataclasses.asdict(DEFAULT_CONFIG).items()) \
        == list(want.items())
    assert {p: getattr(DEFAULT_CONFIG, p) for p in BYTE_MODEL} \
        == {p: getattr(jconfig.DEFAULT_CONFIG, p) for p in BYTE_MODEL}


def _lanes(rng, n, kw):
    """Random u32 lanes drawn mostly from edge words (top bit set or
    not), and pairs that share prefixes."""
    pool = np.array([0, 1, 0x61626364, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
                     0x80000001], np.uint32)
    a = pool[rng.integers(0, len(pool), (n, kw))]
    a[rng.random((n, kw)) < 0.3] = rng.integers(0, 2 ** 32, dtype=np.uint32)
    b = a.copy()
    flip = rng.random((n, kw)) < 0.3
    b[flip] = pool[rng.integers(0, len(pool), flip.sum())]
    alen = rng.integers(0, kw * 4 + 1, n).astype(np.int32)
    blen = np.where(rng.random(n) < 0.5, alen,
                    rng.integers(0, kw * 4 + 1, n)).astype(np.int32)
    return a, alen, b, blen


@pytest.mark.parametrize("kw", [1, 4])
def test_key_helpers_match_reference(kw):
    rng = np.random.default_rng(kw)
    a, alen, b, blen = _lanes(rng, 1500, kw)
    for i in range(300):
        x, y = a[i], b[i]
        for fn in ("key_less", "key_leq"):
            want = getattr(jkeys, fn)(x, int(alen[i]), y, int(blen[i]))
            assert getattr(tkeys, fn)(x, int(alen[i]), y, int(blen[i])) \
                == want
            # the port's int32 bit views order as unsigned words
            assert getattr(tkeys, fn)(x.view(np.int32), int(alen[i]),
                                      y.view(np.int32), int(blen[i])) == want
        want = jkeys.unpack_key(x, int(alen[i]))
        assert tkeys.unpack_key(x, int(alen[i])) == want
        assert tkeys.unpack_key(x.view(np.int32), int(alen[i])) == want
    key = b"\xff\x80hello, world"[:kw * 4]
    assert tkeys.unpack_key(tkeys.pack_key(key, kw), len(key)) == key
    jargs = (jnp.asarray(a), jnp.asarray(alen), jnp.asarray(b),
             jnp.asarray(blen))
    targs = (torch.from_numpy(a.view(np.int32)), torch.from_numpy(alen),
             torch.from_numpy(b.view(np.int32)), torch.from_numpy(blen))
    for jfn, tfn in ((jkeys.jax_key_less, tkeys.torch_key_less),
                     (jkeys.jax_key_leq, tkeys.torch_key_leq)):
        want = np.asarray(jfn(*jargs))
        got = tfn(*targs)
        assert got.dtype == torch.bool and want.dtype == np.bool_
        np.testing.assert_array_equal(got.numpy(), want)
    # broadcasting over a leading dim, as the read path calls them
    want = np.asarray(jkeys.jax_key_less(jargs[0][:, None], jargs[1][:, None],
                                         jargs[2][None, :40],
                                         jargs[3][None, :40]))
    got = tkeys.torch_key_less(targs[0][:, None], targs[1][:, None],
                               targs[2][None, :40], targs[3][None, :40])
    np.testing.assert_array_equal(got.numpy(), want)
