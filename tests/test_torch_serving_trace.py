"""The serving path's own spans (``core/telemetry.SPANS``): each tick a
tree under ``engine.step``, the counts in the spans' tags against counts
derived from the requests alone and against the page table's own
counters, the
engine's ``prefill_s``/``decode_s`` as span durations, the same tokens
with telemetry off, a bounded ring that counts its drops, profiler
ranges under the five names the benchmark knows and only while a capture
is active, and the spans' starts mapped onto the profiler's clock.

The CPU tests run the engine's plain path at smoke sizes (a dense, an
MoE and a Mamba architecture).  The test marked ``gpu`` runs the clock
check with CUDA activity on the card and skips elsewhere; no JAX here."""
from __future__ import annotations

import collections
import json
import math
import statistics

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import telemetry as tm
from repro_torch.core.config import TelemetryConfig
from repro_torch.launch import serve
from repro_torch.serving import ServingEngine

ARCHS = ["qwen2.5-3b", "olmoe-1b-7b", "mamba2-1.3b"]
PAGE = 8
PROMPTS = (5, 13, 8, 17, 3)      # more requests than slots: some wait
NEW = (12, 6, 9, 4, 14)          # answers that cross page boundaries
PROGRAM = {"engine.step", "engine.admit", "engine.prefill",
           "engine.kv_write", "engine.sync", "engine.decode", "engine.h2d",
           "model.prefill", "model.decode", "page_table.put",
           "page_table.reserve", "page_table.lookup", "page_table.export",
           "page_table.get", "page_table.free", "request.queue"}
CHILDREN = {
    "engine.step": {"engine.admit", "engine.prefill", "engine.decode"},
    "engine.prefill": {"page_table.put", "model.prefill", "engine.kv_write",
                       "engine.sync"},
    "engine.decode": {"page_table.reserve", "page_table.lookup",
                      "engine.h2d", "model.decode", "engine.sync",
                      "page_table.free"},
    "page_table.reserve": {"page_table.put"},
    "page_table.lookup": {"page_table.export", "page_table.get"},
}
#: a span starts this long after its profiler range at most, at the median
#: and at the widest (seconds): on the card, as the benchmark asks; on a
#: shared CPU host, where entering a range under a capture that records
#: every op takes tens of microseconds and a thread may be descheduled
CARD_CLOCK_S = (50e-6, 20e-3)
CPU_CLOCK_S = (500e-6, 50e-3)


def _serve(arch, enabled=True, device="cpu"):
    """(engine, tokens per request, the ring's spans) of the requests
    above, served from an empty ring."""
    cfg = get_smoke_config(arch)
    tm.SPANS.clear()
    eng = ServingEngine(cfg, batch_size=3, max_seq=64, page_size=PAGE,
                        device=device,
                        telemetry=TelemetryConfig(enabled=enabled))
    rng = np.random.default_rng(7)
    rids = [eng.submit(rng.integers(1, cfg.vocab, (n,)), max_new_tokens=k)
            for n, k in zip(PROMPTS, NEW)]
    outs = eng.run_until_done()
    return eng, [outs[r] for r in rids], tm.SPANS.spans()


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    return (request.param, *_serve(request.param))


def _by_id(spans):
    return {s.tags["id"]: s for s in spans}


def test_each_tick_is_one_tree(served):
    _, eng, _, spans = served
    ids = _by_id(spans)
    assert len(ids) == len(spans)
    kids = collections.defaultdict(list)
    for s in spans:
        if s.name == "request.queue":
            assert s.tags["parent"] == 0
            continue
        if s.name == "engine.step":
            assert s.tags["parent"] == 0
            continue
        parent = ids[s.tags["parent"]]
        assert s.name in CHILDREN[parent.name], (parent.name, s.name)
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
        kids[parent.tags["id"]].append(s.name)
    steps = [s for s in spans if s.name == "engine.step"]
    assert steps and all(a.t1 <= b.t0 for a, b in zip(steps, steps[1:]))
    for s in steps:
        names = kids[s.tags["id"]]
        assert names.count("engine.admit") == 1
        assert names.count("engine.decode") <= 1
    assert sum(kids[s.tags["id"]].count("engine.decode")
               for s in steps) == eng.stats["decode_steps"]
    assert {s.name for s in spans} == PROGRAM


def test_counts_match_the_requests(served):
    _, eng, outs, spans = served
    ids = _by_id(spans)
    want_puts = want_pos = 0
    for S, out in zip(PROMPTS, outs):
        first = -(-S // PAGE)
        # decode step k writes position S + k; a block it reaches first
        # gets a page
        crossings = sum(1 for pos in range(S, S + len(out) - 1)
                        if pos % PAGE == 0 and pos >= first * PAGE)
        want_puts += first + crossings
        want_pos += sum(S + k + 1 for k in range(len(out) - 1))
    puts = [s for s in spans if s.name == "page_table.put"]
    assert len(puts) == sum(s.tags["puts"] for s in puts) == want_puts
    reserves = [s for s in spans if s.name == "page_table.reserve"]
    assert sum(s.tags["puts"] for s in reserves) == sum(
        1 for s in puts if ids[s.tags["parent"]].name == "page_table.reserve")
    frees = [s for s in spans if s.name == "page_table.free"]
    assert len(frees) == len(PROMPTS)
    assert sum(s.tags["deletes"] for s in frees) == want_puts
    for f in frees:   # each request releases every page it was given
        assert f.tags["deletes"] == sum(1 for s in puts
                                        if s.tags["rid"] == f.tags["rid"])
    decodes = [s for s in spans if s.name == "engine.decode"]
    lookups = [s for s in spans if s.name == "page_table.lookup"]
    assert len(lookups) == len(decodes) == eng.stats["decode_steps"]
    assert sorted(ids[s.tags["parent"]].tags["id"] for s in lookups) == \
        sorted(s.tags["id"] for s in decodes)
    assert sum(s.tags["rows"] for s in decodes) == \
        sum(len(o) - 1 for o in outs)
    assert sum(s.tags["positions"] for s in decodes) == want_pos
    assert [s.tags["gets"] for s in reserves] == \
        [s.tags["rows"] for s in decodes]
    table = eng.kv.table
    assert (table.stats.puts, table.stats.deletes) == (want_puts, want_puts)
    pipe = table.pipeline_stats
    assert pipe.padded_lanes - pipe.dispatched_lanes == \
        sum(s.tags["padded"] for s in lookups)
    exports = [s for s in spans if s.name == "page_table.export"]
    assert table.sync_stats.delta_rows == sum(s.tags["rows"] for s in exports)
    assert table.sync_stats.bytes_synced == \
        sum(s.tags["bytes"] for s in exports)
    assert [s.tags["rid"] for s in spans if s.name == "request.queue"] \
        == sorted(s.tags["rid"] for s in spans
                  if s.name == "engine.prefill")


def test_engine_timers_are_span_durations(served):
    _, eng, _, spans = served
    pre = {s.tags["rid"]: s.t1 - s.t0 for s in spans
           if s.name == "engine.prefill"}
    assert pre == eng.prefill_s and len(pre) == len(PROMPTS)
    assert eng.decode_s == [s.t1 - s.t0 for s in spans
                            if s.name == "engine.decode"]
    queue = {s.tags["rid"]: s for s in spans if s.name == "request.queue"}
    for s in spans:
        if s.name == "engine.prefill":
            assert queue[s.tags["rid"]].t1 == s.t0


def test_telemetry_off_records_nothing(served):
    arch, eng, outs, _ = served
    off, outs_off, spans = _serve(arch, enabled=False)
    assert outs_off == outs and spans == []
    # the engine's timers keep their meaning without the ring
    assert off.prefill_s.keys() == eng.prefill_s.keys()
    assert len(off.decode_s) == len(eng.decode_s)
    assert all(t > 0 for t in [*off.prefill_s.values(), *off.decode_s])
    assert off.kv.table.stats == eng.kv.table.stats and off.stats == eng.stats
    assert not off._submit_t


def test_ring_is_bounded_and_counts_its_drops():
    assert tm.SPANS.capacity >= 2 ** 17
    with tm.CLOCK.frozen():
        ring = tm.SpanRing(capacity=8)
        for k in range(1, 21):          # span k runs from k to k + 0.5
            tm.CLOCK.freeze(float(k))
            with tm.span(ring, "engine.h2d"):
                tm.CLOCK.advance(0.5)
    assert len(ring) == 8 and ring.dropped == 12
    # the 12th span ran from 12.0 to 12.5; the ring holds 13.0 on
    assert ring.dropped_t1 == 12.5
    assert ring.window(12.0, 30.0) is None
    kept = ring.window(12.5, 30.0)
    assert [s.t0 for s in kept] == [13.0 + k for k in range(8)]
    assert [s.t1 for s in ring.window(15.0, 17.5)] == [15.5, 16.5, 17.5]
    got = {n: v for n, _, v, _ in ring.collect()}
    assert got == {"spans_held": 8, "spans_dropped": 12}
    ring.clear()
    assert not len(ring) and ring.window(0.0, 1.0) == []


def test_page_table_totals_speak_the_registry(served):
    """The page table's totals are its store's own counters, and they and
    the ring read through the registry as the spans count them."""
    _, eng, _, spans = served
    table = eng.kv.table
    reg = tm.MetricsRegistry()
    for source in (table.stats, table.sync_stats, table.pipeline_stats):
        reg.register(lambda source=source: source)
    reg.register(lambda: tm.SPANS)
    snap = reg.snapshot()
    assert snap["tree_puts{layer=btree}"] == sum(
        s.tags["puts"] for s in spans if s.name == "page_table.put")
    assert snap["tree_deletes{layer=btree}"] == sum(
        s.tags["deletes"] for s in spans if s.name == "page_table.free")
    assert snap["sync_bytes_synced{layer=shard}"] == sum(
        s.tags["bytes"] for s in spans if s.name == "page_table.export")
    assert snap["spans_held{layer=spans}"] == len(tm.SPANS)
    assert snap["spans_dropped{layer=spans}"] == 0


def _profiled(arch, device):
    """(spans, the profiler's raw events, its Chrome export) of a serve
    under a ``torch.profiler`` capture."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        _, _, spans = _serve(arch, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
    return spans, list(prof.profiler.kineto_results.events()), prof


def _clock_check(spans, events, tolerance):
    """Each span of the five names, mapped onto the profiler's clock,
    starts within ``tolerance`` (median, widest) of its range."""
    diffs = []
    for name in tm.PROFILER_RANGES:
        ranges = sorted(e.start_ns() for e in events if e.name() == name
                        and e.device_type() == torch.autograd.DeviceType.CPU)
        mine = sorted(tm.to_profiler_ns(s.t0) for s in spans
                      if s.name == name)
        assert len(ranges) == len(mine) > 0, name
        diffs += [(m - r) / 1e9 for m, r in zip(mine, ranges)]
    median, widest = tolerance
    assert abs(statistics.median(diffs)) < median, diffs
    assert max(abs(d) for d in diffs) < widest, diffs


def test_profiler_ranges_only_under_a_capture(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    _serve("qwen2.5-3b")
    assert entered == []
    spans, events, _ = _profiled("qwen2.5-3b", "cpu")
    want = collections.Counter(s.name for s in spans
                               if s.name in tm.PROFILER_RANGES)
    assert collections.Counter(entered) == want
    seen = collections.Counter(e.name() for e in events
                               if e.name() in PROGRAM)
    assert seen == want and set(want) == tm.PROFILER_RANGES


def test_spans_land_on_the_profiler_clock(tmp_path):
    spans, events, prof = _profiled("olmoe-1b-7b", "cpu")
    _clock_check(spans, events, CPU_CLOCK_S)
    # the Chrome exports of both, on one time axis
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    theirs = json.loads(path.read_text())
    base = theirs.get("baseTimeNanoseconds", 0)
    ours = tm.SpanRing()
    for s in spans:
        ours._append((s.name, s.t0, s.t1, s.tags))
    mine = ours.chrome_trace(base)
    assert mine["baseTimeNanoseconds"] == base
    assert len(mine["traceEvents"]) == len(spans)
    for name in tm.PROFILER_RANGES:
        a = sorted(e["ts"] for e in theirs["traceEvents"]
                   if e.get("name") == name and e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
        b = sorted(e["ts"] for e in mine["traceEvents"] if e["name"] == name)
        assert len(a) == len(b)
        d = [(y - x) * 1e-6 for x, y in zip(a, b)]
        assert abs(statistics.median(d)) < CPU_CLOCK_S[0], (name, d)


def test_serve_cli_writes_the_spans(tmp_path, capsys):
    path = tmp_path / "spans.json"
    tm.SPANS.clear()
    serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                "--new-tokens", "3", "--trace", str(path)])
    got = json.loads(path.read_text())
    evs = got["traceEvents"]
    assert len(evs) == len(tm.SPANS) > 0
    assert {e["name"] for e in evs} <= PROGRAM
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
    assert {(e["pid"], e["tid"]) for e in evs
            if e["name"] == "request.queue"} == {(1, 0), (1, 1), (1, 2)}
    steps = sorted(e["ts"] for e in evs if e["name"] == "engine.step")
    assert steps and all(math.isfinite(t) for t in steps)
    # microseconds since the Unix epoch, as the profiler counts
    assert 1.5e15 < steps[0] < 1e17
    assert "written to" in capsys.readouterr().out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_profiler_clock_and_device_names_on_the_card(cuda):
    from repro_torch.kernels import build
    build.build(["fused_read", "row_scatter", "paged_attention"])
    _serve("olmoe-1b-7b", device="cuda")     # builds and warms
    spans, events, _ = _profiled("olmoe-1b-7b", "cuda")
    _clock_check(spans, events, CARD_CLOCK_S)
    device = {e.name() for e in events
              if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert device and not (device & PROGRAM) - tm.PROFILER_RANGES
