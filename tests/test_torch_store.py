"""End to end: a ``repro_torch`` HoneycombStore on the CPU and a
``repro.core`` HoneycombStore fed the same ops give equal GET/SCAN
answers, serving versions, SyncStats, PipelineStats lane counts and
CacheStats device meters, under all three sync policies; plus the port's
refusals (no CUDA, an unknown layout, an unknown device) and
chip_smoke.py's refusal to run without a card."""
from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import HoneycombConfig as JConfig
from repro.core import HoneycombStore as JStore
from repro_torch.core import HoneycombConfig as TConfig
from repro_torch.core import HoneycombStore as TStore
from repro_torch.core.keys import int_key

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(node_cap=16, log_cap=4, n_shortcuts=4, cache_slots=32,
             max_scan_leaves=2, max_scan_items=16, max_height=6)
PIPELINE_COUNTS = ("staged_exports", "flips", "dispatched_lanes",
                   "padded_lanes")


def _drive(geometry, n_items, heap_capacity, rounds=5, seed=0):
    """Feed both stores one op stream; compare after every read."""
    j = JStore(JConfig(**geometry), heap_capacity=heap_capacity)
    t = TStore(TConfig(**geometry), heap_capacity=heap_capacity,
               device="cpu")
    rng = np.random.default_rng(seed)

    def both(op, *args):
        return getattr(j, op)(*args), getattr(t, op)(*args)

    for i in rng.permutation(n_items):
        both("put", int_key(int(i)), b"v%06d" % i)
    for r in range(rounds):
        for i in rng.integers(0, n_items + 20, 30):
            draw = rng.random()
            k = int_key(int(i))
            if draw < 0.5:
                both("update", k, b"r%d-%d" % (r, i))
            elif draw < 0.6:       # past the inline budget: overflow heap
                both("put", k, b"o" * 40 + b"%d" % i)
            elif draw < 0.85:
                both("delete", k)
            else:
                both("put", k + b"\x07", b"n%d" % i)
        if r % 2:
            assert t.collect_garbage() == j.collect_garbage()
        if geometry.get("sync_policy") == "explicit" and r % 2 == 0:
            both("export_snapshot")
        keys = [int_key(int(i)) for i in rng.integers(0, n_items + 20, 13)]
        ranges = [(int_key(int(i)), int_key(int(i) + int(w)))
                  for i, w in zip(rng.integers(0, n_items, 7),
                                  rng.choice([0, 4, 30], 7))]
        jg, tg = both("get_batch", keys)
        assert tg == jg
        js, ts = both("scan_batch", ranges)
        assert ts == js
        assert t.serving_version == j.serving_version
        assert dataclasses.asdict(t.sync_stats) \
            == dataclasses.asdict(j.sync_stats)
        assert dataclasses.asdict(t.cache_stats) \
            == dataclasses.asdict(j.cache_stats)
        for f in PIPELINE_COUNTS:
            assert getattr(t.pipeline_stats, f) \
                == getattr(j.pipeline_stats, f), f
        assert t.epoch == j.epoch
    return j, t


@pytest.mark.parametrize("policy", ["on_read", "every_k", "explicit"])
def test_store_matches_reference(policy):
    geometry = dict(SMALL, sync_policy=policy, sync_every_k=16,
                    lb_fraction=0.25)
    j, t = _drive(geometry, 200, heap_capacity=512)
    s = t.sync_stats
    assert s.full_syncs >= 1 and s.delta_syncs >= 1
    assert t.cache_stats.lb_routed > 0


def test_store_matches_reference_through_growth_and_reference_backend():
    """A heap that outgrows its capacity (full republish after growth),
    served by the staged reference read path."""
    geometry = dict(SMALL, read_backend="reference")
    j, t = _drive(geometry, 150, heap_capacity=32, rounds=3)
    assert t.tree.heap.generation > 1
    assert t.cache_stats.vmem_hits == 0       # the fused path never ran


def test_store_matches_reference_default_geometry():
    j, t = _drive({}, 900, heap_capacity=64, rounds=2, seed=1)
    assert t.tree.height >= 2


def test_store_refuses_what_it_cannot_serve(monkeypatch):
    with pytest.raises(AssertionError):
        TConfig(layout="columnar")
    # the legacy per-field layout is served (tests/test_torch_layout.py)
    legacy = TStore(TConfig(layout="legacy"), device="cpu")
    legacy.put(b"k", b"v")
    assert legacy.get_batch([b"k"]) == [b"v"]
    st = TStore(device="cpu")
    st.put(b"k", b"v")
    # an unreplicated store captures no log for the replication feed
    assert not st.log_capture and st._epoch_log == []
    assert st.get_batch([b"k"]) == [b"v"]
    with pytest.raises(ValueError):
        TStore(device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TStore()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a CUDA device, and in a directory holding chip_smoke.py and
    nothing else of the repository, the smoke exits non-zero and prints
    no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for where in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
