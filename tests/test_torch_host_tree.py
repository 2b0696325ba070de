"""The port's host B+Tree (heap, page table, MVCC, GC, btree) held to the
JAX reference's: a randomized put/update/delete/GC sequence must leave
identical heap arrays, packed images, page tables, TreeStats and
fast-path placements after every write."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core.btree import HoneycombTree as JTree
from repro.core.config import HoneycombConfig as JConfig
from repro.core.schema import NodeImageLayout as JLayout
from repro_torch.core.btree import HoneycombTree as TTree
from repro_torch.core.config import HoneycombConfig as TConfig
from repro_torch.core.keys import int_key
from repro_torch.core.schema import FIELD_NAMES
from repro_torch.core.schema import NodeImageLayout as TLayout


def _assert_trees_equal(j, t):
    for name in FIELD_NAMES + ("lockword",):
        np.testing.assert_array_equal(getattr(t.heap, name),
                                      getattr(j.heap, name), err_msg=name)
    assert t.heap.dirty == j.heap.dirty
    assert t.heap.capacity == j.heap.capacity
    np.testing.assert_array_equal(t.pt.host, j.pt.host)
    assert t.pt.pending == j.pt.pending
    assert (t.root_lid, t.height) == (j.root_lid, j.height)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert (t.versions.global_write_version, t.versions.device_read_version) \
        == (j.versions.global_write_version, j.versions.device_read_version)
    np.testing.assert_array_equal(t.overflow.vals, j.overflow.vals)


@pytest.mark.parametrize("seed,geometry", [
    (0, dict(node_cap=16, log_cap=4, n_shortcuts=4)),
    (1, dict(node_cap=8, log_cap=2, n_shortcuts=2, val_words=2)),
    (2, dict())])
def test_random_ops_give_identical_trees(seed, geometry):
    rng = np.random.default_rng(seed)
    j = JTree(JConfig(**geometry), heap_capacity=16)
    t = TTree(TConfig(**geometry), heap_capacity=16)
    n_keys = 400
    for step in range(1500):
        k = int_key(int(rng.integers(0, n_keys)))
        draw = rng.random()
        # a few values overflow the inline budget into the overflow heap
        v = b"x" * int(rng.choice([3, 8, 16, 40]))
        if draw < 0.55:
            j.put(k, v), t.put(k, v)
        elif draw < 0.75:
            j.update(k, v), t.update(k, v)
        elif draw < 0.95:
            j.delete(k), t.delete(k)
        else:
            assert t.gc.collect() == j.gc.collect()
        assert t.last_placement == j.last_placement
        if step % 100 == 0:
            _assert_trees_equal(j, t)
    _assert_trees_equal(j, t)
    t.check_invariants()
    np.testing.assert_array_equal(TLayout.for_config(t.cfg).pack(t.heap),
                                  JLayout.for_config(j.cfg).pack(j.heap))
    assert t.pt.take_pending()[0].tolist() == j.pt.take_pending()[0].tolist()
    lo, hi = int_key(50), int_key(250)
    assert t.scan(lo, hi) == j.scan(lo, hi)
    assert [t.get(int_key(i)) for i in range(n_keys)] \
        == [j.get(int_key(i)) for i in range(n_keys)]
