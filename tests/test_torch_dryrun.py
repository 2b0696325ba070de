"""The port's dry-run tools held to the reference's, on the CPU:
``launch/hlo_analysis.py`` (roofline arithmetic, model FLOPs, and the
dispatch-level counters that stand for XLA's analyses), ``launch/
dryrun.py`` (cells, and ``build_step`` traced on fake worlds) and the
mesh-scale half of ``launch/store_dryrun.py``.

The reference's ``repro.launch.dryrun`` and ``repro.launch.store_dryrun``
set ``XLA_FLAGS`` to 512 host devices when imported, which would reach
every later test of this pytest worker, so their figures come from one
subprocess per module (``reference`` fixture) that prints them as JSON;
``repro.launch.hlo_analysis`` and ``repro.configs`` are imported here.

The collective and memory counters are held to hand arithmetic; a step
traced under ``FakeTensorMode`` to the same step on real CPU tensors
(FLOPs, bytes accessed and every memory figure exactly equal).  Each fake
world is opened and destroyed inside its test."""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import compat
from repro_torch.configs import ALIASES, ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.core import HoneycombConfig
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.launch import dryrun as dr
from repro_torch.launch import hlo_analysis as hla
from repro_torch.launch import store_dryrun as sd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import config as mc
from repro_torch.models.config import LM_SHAPES, ShapeConfig

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300

REF_SCRIPT = textwrap.dedent(r"""
    import json, sys
    import repro.launch.dryrun as jd          # sets XLA_FLAGS on import
    import repro.launch.store_dryrun as js
    from repro.configs import ALIASES
    from repro.core import HoneycombConfig
    from repro.models.config import LM_SHAPES
    cfg = HoneycombConfig()
    out = {"cells": [list(c) for c in jd.cells(
        list(ALIASES), [s.name for s in LM_SHAPES])],
           "snapshots": {}, "delta_sync": {}}
    for n, shards in ((128_000_000, 256), (64, 1)):
        snap, S = js.abstract_snapshot(cfg, n, shards)
        out["snapshots"][f"{n}/{shards}"] = {
            "S": S, "fields": [[f, list(getattr(snap, f).shape),
                                str(getattr(snap, f).dtype)]
                               for f in snap._fields]}
        for d, p in ((256, 64), (16, 4)):
            r = js.delta_sync_analysis(cfg, snap, d, p)
            r.pop("compiled_temp_gb")
            out["delta_sync"][f"{n}/{shards}/{d}/{p}"] = r
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=REF_TIMEOUT,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ hlo_analysis
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    from repro.configs import get_config as jget
    from repro.launch import hlo_analysis as jhla
    for shape in LM_SHAPES:
        assert hla.model_flops_per_step(get_config(arch), shape) \
            == jhla.model_flops_per_step(jget(arch), shape)


def test_long_context_ok_and_cells_match_reference(reference):
    from repro.configs import get_config as jget
    from repro.models.config import long_context_ok as jok
    for arch in ARCH_IDS:
        assert mc.long_context_ok(get_config(arch)) == jok(jget(arch))
    cells = [list(c) for c in dr.cells(list(ALIASES),
                                       [s.name for s in LM_SHAPES])]
    assert cells == reference["cells"]
    assert any(c[2] == "skip" for c in cells)


ROOFLINE_CASES = {
    "compute": ({"flops": 4e15, "bytes accessed": 1e9}, 1e6, 1e15),
    "memory": ({"flops": 1e9, "bytes accessed": 8e12}, 1e6, 1e8),
    "collective": ({"flops": 1e9, "bytes accessed": 1e9}, 3e12, 0.0),
    "zero_flops": ({"flops": 0.0, "bytes accessed": 5e8}, 0, 7.0),
    "list_form": ([{"flops": 2e12, "bytes accessed": 3e10}], 1e9, 1e12),
    "empty_list": ([], 0, 0.0),
}


@pytest.mark.parametrize("case", list(ROOFLINE_CASES))
def test_roofline_matches_reference_with_its_constants(monkeypatch, case):
    """With the port's data-sheet constants patched to the reference's
    (TPU v5e), every field of ``to_dict`` is the reference's."""
    from repro.launch import hlo_analysis as jhla
    monkeypatch.setattr(hla, "PEAK_FLOPS", jhla.PEAK_FLOPS)
    monkeypatch.setattr(hla, "HBM_BW", jhla.HBM_BW)
    monkeypatch.setattr(hla, "LINK_BW", jhla.ICI_BW)
    cost, coll, mf = ROOFLINE_CASES[case]
    want = jhla.roofline(cost, {"total_bytes": coll}, mf).to_dict()
    got = hla.roofline(cost, {"total_bytes": coll}, mf).to_dict()
    assert got == want
    if case in ("compute", "memory", "collective"):
        assert got["dominant"] == case


def test_roofline_constants_are_the_h100_data_sheet():
    assert (hla.PEAK_FLOPS, hla.HBM_BW, hla.LINK_BW) \
        == (989e12, 3.35e12, 450e9)


@pytest.fixture
def world():
    """A fake world of 4 ranks and a (2, 2) ("data", "model") mesh."""
    with dr.fake_world(4):
        yield make_mesh((2, 2), ("data", "model"), "cpu")


def _zeros():
    return {"bytes": dict.fromkeys(hla.COLLECTIVES, 0),
            "counts": dict.fromkeys(hla.COLLECTIVES, 0), "total_bytes": 0}


def _one(kind: str, nbytes: int, count: int = 1) -> dict:
    want = _zeros()
    want["bytes"][kind] = nbytes
    want["counts"][kind] = count
    want["total_bytes"] = nbytes
    return want


def _dt(local, mesh, pl):
    return DTensor.from_local(local, mesh, pl, run_check=False)


COLLECTIVE_CASES = {
    # a [4, 6] f32 block on each of the data ranks, gathered: [8, 6]
    "all_gather": (lambda m: _dt(torch.ones(4, 6), m, [Shard(0),
                                                       Replicate()])
                   .full_tensor(), "all-gather", 8 * 6 * 4),
    # partial sums of [8, 6] scattered over the data axis: [4, 6]
    "reduce_scatter": (lambda m: _dt(torch.ones(8, 6), m, [Partial(),
                                                           Replicate()])
                       .redistribute(m, [Shard(0), Replicate()]),
                       "reduce-scatter", 4 * 6 * 4),
    # partial sums of [8, 6] reduced over the model axis: [8, 6]
    "all_reduce": (lambda m: _dt(torch.ones(8, 6), m, [Replicate(),
                                                       Partial()])
                   .redistribute(m, [Replicate(), Replicate()]),
                   "all-reduce", 8 * 6 * 4),
    "psum": (lambda m: compat.psum(torch.ones(3, 5), m, "data"),
             "all-reduce", 3 * 5 * 4),
    # a ring over the model axis: this rank receives one [3, 5] bf16
    "ppermute": (lambda m: compat.ppermute(
        torch.ones(3, 5, dtype=torch.bfloat16), m, "model",
        [(0, 1), (1, 0)]), "collective-permute", 3 * 5 * 2),
    # [8, 4] f32 exchanged in equal splits over the data axis
    "all_to_all": (lambda m: funcol.all_to_all_single(
        torch.ones(8, 4), None, None, m.get_group("data")).wait(),
        "all-to-all", 8 * 4 * 4),
}


@pytest.mark.parametrize("case", list(COLLECTIVE_CASES))
def test_collective_counter_meters_result_bytes(world, case):
    fn, kind, nbytes = COLLECTIVE_CASES[case]
    assert hla.collective_bytes(fn, world) == _one(kind, nbytes)


def test_collective_counter_counts_each_call_and_nothing_else(world):
    def two(m):
        compat.psum(torch.ones(2, 2), m, ("data", "model"))
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert hla.collective_bytes(two, world) == _one("all-reduce", 32, 2)
    assert hla.collective_bytes(lambda: torch.ones(8).sum()) == _zeros()


def test_memory_counter_on_a_hand_sized_call():
    """A [1024, 1024] f32 temporary made and dropped is 4 MiB of temp;
    the output is its own figure; an in-place donated argument is alias."""
    x = torch.ones(16)

    def f(x):
        t = torch.ones(1024, 1024)
        y = x * 2
        del t
        return y
    tr = hla.trace(f, (x,))
    assert tr.memory == {"argument_bytes": 64, "output_bytes": 64,
                         "temp_bytes": 4 << 20, "alias_bytes": 0,
                         "peak_bytes": 128 + (4 << 20)}
    assert tr.cost == {"flops": 0.0, "bytes accessed":
                       float((4 << 20) + 64 + 64)}

    def g(x):
        return x.add_(1)
    tr = hla.trace(g, (x,), donate_argnums=(0,))
    assert tr.memory == {"argument_bytes": 64, "output_bytes": 64,
                         "temp_bytes": 0, "alias_bytes": 64,
                         "peak_bytes": 64}
    mm = hla.trace(lambda a, b: a @ b, (torch.ones(8, 16), torch.ones(16, 4)))
    assert mm.cost["flops"] == 2 * 8 * 16 * 4


# ------------------------------------------------------------------ dryrun
SMOKE_SHAPES = {
    "train": ShapeConfig("t", "train", seq_len=16, global_batch=8,
                         page_size=8),
    "prefill": ShapeConfig("p", "prefill", seq_len=16, global_batch=4,
                           page_size=8),
    "decode": ShapeConfig("d", "decode", seq_len=32, global_batch=4,
                          page_size=8),
}


def _real(gen):
    """Blocks with values: small normals, token ids, lengths and pages
    0, so that the real step runs."""
    def make(shape, dtype):
        if dtype.is_floating_point:
            return (torch.randn(shape, generator=gen) * 0.02).to(dtype)
        return torch.zeros(shape, dtype=dtype)
    return make


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_fake_trace_equals_a_real_cpu_run(kind):
    """On a (1, 1) fake world, the step traced under ``FakeTensorMode``
    counts the FLOPs, bytes and every memory figure of the same step on
    real CPU tensors."""
    cfg = get_smoke_config("qwen2p5_3b")
    shape = SMOKE_SHAPES[kind]
    with dr.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        fake = dr.trace_cell(cfg, shape, mesh, grad_accum=2)
        real = dr.trace_cell(cfg, shape, mesh, grad_accum=2,
                             make=_real(torch.Generator().manual_seed(0)))
    assert fake.cost == real.cost and fake.memory == real.memory
    assert fake.collectives == real.collectives
    assert fake.cost["flops"] > 0 and fake.memory["temp_bytes"] > 0
    assert fake.memory["argument_bytes"] > 0


def _local_bytes(specs, pls, mesh) -> int:
    """Rank 0's bytes of a tree of specs under its placements, by hand:
    each dimension a mesh dimension shards divided by that dimension's
    size."""
    from repro_torch.models.schema import Spec
    if isinstance(specs, Spec):
        shape = list(specs.shape)
        for i, p in enumerate(pls):
            if isinstance(p, Shard):
                shape[p.dim] //= mesh.size(i)
        return math.prod(shape) * specs.dtype.itemsize
    if isinstance(specs, dict):
        return sum(_local_bytes(v, pls[k], mesh) for k, v in specs.items())
    return sum(_local_bytes(s, p, mesh) for s, p in zip(specs, pls)
               if s is not None)


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_dry_run_on_a_two_by_two_world(kind):
    """Rank 0 of a (2, 2) fake world: the step traces, and its argument
    bytes are the local shard bytes its placements give."""
    from repro_torch.launch.steps import build_step
    cfg = get_smoke_config("qwen2p5_3b")
    shape = SMOKE_SHAPES[kind]
    with dr.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        tr = dr.trace_cell(cfg, shape, mesh, grad_accum=2)
        built = build_step(cfg, shape, mesh, grad_accum=2)
        want = _local_bytes(built.abstract_args, built.in_shardings, mesh)
    rec = dr.cell_record(cfg, shape, "2x2", 4, tr, 0.0)
    assert rec["status"] == "ok" and rec["roofline"]["flops"] > 0
    assert rec["memory"]["argument_bytes"] == want
    assert sum(rec["collectives"]["counts"].values()) > 0
    assert (kind == "decode") == ("attention" in rec)


@pytest.mark.parametrize("impl", ["fsliced", "ep_ragged"])
def test_dry_run_of_a_ragged_moe(impl):
    """A ragged MoE step on a (2, 2) fake world: the fake group sizes
    split the rows evenly, and the FLOPs are those of the real split."""
    cfg = dataclasses.replace(get_smoke_config("olmoe_1b_7b"),
                              capacity_factor=8.0)
    shape = SMOKE_SHAPES["train"]
    policy = ShardingPolicy(expert_parallel=impl == "ep_ragged")
    with dr.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        tr = dr.trace_cell(cfg, shape, mesh, policy, impl, grad_accum=2)
    assert tr.cost["flops"] > 0
    assert tr.collectives["counts"]["all-reduce"] > 0


def test_ragged_group_sizes_of_a_fake_tensor_split_evenly():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import moe as me
    eid = torch.tensor([3, 0, 0, 2, 3, 3, 1])
    assert me._group_sizes(eid, 4) == [2, 1, 1, 3]
    with FakeTensorMode():
        assert me._group_sizes(torch.zeros(10, dtype=torch.int64), 4) \
            == [3, 3, 2, 2]


def test_fake_world_refuses_a_live_process_group():
    with dr.fake_world(2):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dr.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_run_cell_qwen_decode_full_size():
    """qwen2.5-3b ``decode_32k`` at full size on the (16, 16) fake world:
    rank 0's record, every layer traced, nothing allocated."""
    r = dr.run_cell("qwen2.5-3b", "decode_32k", False, ShardingPolicy(),
                    "dense")
    assert r["status"] == "ok" and r["mesh"] == "16x16"
    assert r["memory"]["peak_bytes"] > 0 and r["roofline"]["flops"] > 0
    assert r["collectives"]["counts"]["all-gather"] > 0
    cfg, shape = get_config("qwen2.5-3b"), mc.shape_by_name("decode_32k")
    assert r["roofline"]["model_flops"] \
        == hla.model_flops_per_step(cfg, shape) / 256
    assert not dist.is_initialized()


def test_dryrun_main_writes_the_reference_layout(tmp_path, monkeypatch):
    """The CLI: one cell per key (the reference's key), a skip record for
    an inapplicable cell, a cached cell not run again, exit 0; the
    reference's ``benchmarks/roofline.py`` renders the file; a failing
    cell is recorded with its error and the exit code is 1."""
    calls = []

    def fake_run(arch, shape, multi, policy, moe_impl, grad_accum=4):
        calls.append((arch, shape, multi))
        return {"arch": arch, "shape": shape, "mesh": "16x16",
                "status": "ok", "compile_s": 0.0,
                "memory": {"peak_bytes": 0},
                "roofline": hla.roofline({}, {"total_bytes": 0},
                                         0.0).to_dict()}
    monkeypatch.setattr(dr, "run_cell", fake_run)
    out = tmp_path / "torch_dryrun.json"
    argv = ["--arch", "qwen2.5-3b", "--mesh", "single", "--out", str(out)]
    assert dr.main(argv) == 0
    res = json.loads(out.read_text())
    assert set(res) == {f"qwen2.5-3b|{s.name}|single" for s in LM_SHAPES}
    assert res["qwen2.5-3b|long_500k|single"]["status"] == "skip"
    assert res["qwen2.5-3b|decode_32k|single"]["policy"] == "base"
    assert len(calls) == 3
    assert dr.main(argv) == 0 and len(calls) == 3      # cached
    # the reference's roofline table reads the port's file
    from benchmarks.roofline import render
    table = render(out)
    assert "| qwen2.5-3b | decode_32k |" in table and "SKIP" in table

    def failing(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dr, "run_cell", failing)
    assert dr.main(argv + ["--force", "--shape", "train_4k"]) == 1
    rec = json.loads(out.read_text())["qwen2.5-3b|train_4k|single"]
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: boom"


# ------------------------------------------------------------ store_dryrun
@pytest.mark.parametrize("sizing", ["128000000/256", "64/1"])
def test_abstract_snapshot_matches_reference(reference, sizing):
    n, shards = map(int, sizing.split("/"))
    snap, S = sd.abstract_snapshot(HoneycombConfig(), n, shards)
    want = reference["snapshots"][sizing]
    assert S == want["S"]
    got = [[f, list(getattr(snap, f).shape)] for f in snap._fields]
    assert got == [[f, shape] for f, shape, _ in want["fields"]]
    # the port's int32 bit view of the reference's u32 image words
    assert {str(getattr(snap, f).dtype) for f in snap._fields} \
        == {"torch.int32"}
    assert [d for _, _, d in want["fields"]] \
        == ["uint32", "int32", "int32", "int32", "int32", "uint32"]


@pytest.mark.parametrize("case", ["128000000/256/256/64",
                                  "128000000/256/16/4", "64/1/256/64",
                                  "64/1/16/4"])
def test_delta_sync_analysis_matches_reference(reference, case):
    n, shards, d, p = map(int, case.split("/"))
    snap, _ = sd.abstract_snapshot(HoneycombConfig(), n, shards)
    assert sd.delta_sync_analysis(HoneycombConfig(), snap, d, p) \
        == reference["delta_sync"][case]


def test_delta_sync_at_the_paper_deployment():
    snap, S = sd.abstract_snapshot(HoneycombConfig(), 128_000_000, 256)
    r = sd.delta_sync_analysis(HoneycombConfig(), snap)
    assert S == 14_681
    assert (r["delta_bytes_per_sync"], r["full_snapshot_bytes"]) \
        == (1_306_120, 76_118_960)


@pytest.mark.parametrize("export_s,read_s", [(3e-3, 1e-3), (1e-3, 4e-3),
                                             (2e-3, 2e-3)])
def test_pipeline_occupancy_arithmetic(export_s, read_s):
    r = sd.pipeline_occupancy_model(export_s, read_s, 250, 512)
    slow = max(export_s, read_s)
    assert r["serial_epoch_s"] == export_s + read_s
    assert r["pipelined_epoch_s"] == slow
    assert r["pipeline_speedup"] == (export_s + read_s) / slow
    assert r["stage_occupancy"] == {"export": export_s / slow,
                                    "read": read_s / slow}
    assert r["bottleneck_stage"] == ("export" if export_s >= read_s
                                     else "read")
    assert (r["dirty_rows"], r["batch_per_shard"]) == (250, 512)


@pytest.mark.parametrize("scan,want", [
    # 100 rows of 1,273 words; 512 keys of 8 words and a length (twice for
    # a SCAN's lo and hi); found, length and 4 value words, or count,
    # trunc and 32 items of 8 + 4 + 2 words
    (False, 100 * 1273 * 4 + 512 * 9 * 4 + 512 * 4 * 6),
    (True, 100 * 1273 * 4 + 2 * 512 * 9 * 4 + 512 * 4 * (2 + 32 * 14))])
def test_fused_read_byte_bound_by_hand(scan, want):
    from repro_torch.kernels import fused_read
    assert fused_read.bytes_moved(HoneycombConfig(), 100, 512,
                                  scan=scan) == want


def test_get_bytes_reads_the_walks_rows():
    """The store dry run's GET bytes are the kernel's bound over the rows
    the plain walk marks on the CPU."""
    from repro_torch.kernels import fused_read, ref
    store = sd.live_shard(300, "cpu")
    snap = store.export_snapshot()
    _, keys, lens = sd.read_batch(store, 8, 300)
    touched = torch.zeros(snap.image.shape[0] + snap.cache_image.shape[0],
                          dtype=torch.int32)
    ref.batched_get_fused_ref(snap, keys, lens, cfg=store.cfg,
                              touched=touched)
    rows = int(touched.sum())
    assert rows > 0
    assert sd.get_bytes(snap, keys, lens, store.cfg) \
        == fused_read.bytes_moved(store.cfg, rows, 8) \
        == rows * 1273 * 4 + 8 * 9 * 4 + 8 * 4 * 6


def test_mesh_scale_on_the_cpu_times_nothing():
    """A live shard of 3,000 keys: the abstract sizes, the live delta near
    256 rows, the collective-free read, the byte bound; no stage timed."""
    r = sd.mesh_scale(device="cpu", shard_keys=3000)
    assert r["slots_per_shard"] == 14_681 and r["pipeline"] is None
    assert r["collective_bytes"] == 0 and r["temp_bytes"] is None
    live = r["delta_sync"]["live_delta"]
    assert 248 <= live["distinct_rows"] <= live["rows"] == 256
    assert r["reads_per_s_per_chip_bound"] > 0
    assert "apply_peak_rise_bytes" not in r["delta_sync"]
    with pytest.raises(RuntimeError, match="timed on the card"):
        store = sd.live_shard(300, "cpu")
        base, delta, *_ = sd.stage_delta(store, 16)
        sd.pipeline_stages(store, base, delta,
                           *sd.read_batch(store, 8, 300)[1:])
