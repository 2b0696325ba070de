"""The readers of the program's spans (``metrics/page_table_ms_per_step``,
``page_table_ops_per_step``, ``decode_launch_ms``, ``queue_wait_p95_ms``)
on a ring built by hand, against values worked out by hand; None where
the ring dropped spans from the window or the program has no ring; and
a number from each on a smoke run of the closed loop."""
import pytest

import smoke
from bench import harness
from repro_torch.core import telemetry as tm

READERS = ("page_table_ms_per_step", "page_table_ops_per_step",
           "decode_launch_ms", "queue_wait_p95_ms")


def _ring(capacity=64):
    """Two ticks inside the window (10, 20], and spans on both sides."""
    ring = tm.SpanRing(capacity)
    spans = [   # (id, parent, name, t0, t1, tags), in order of t1
        (1, 0, "request.queue", 8.0, 9.5, {"rid": 9}),        # before
        (3, 2, "engine.admit", 10.10, 10.15, {}),
        (5, 4, "page_table.put", 10.20, 10.25, {"puts": 1}),
        (6, 4, "page_table.put", 10.25, 10.30, {"puts": 1}),
        (7, 4, "model.prefill", 10.30, 10.55, {}),
        (4, 2, "engine.prefill", 10.20, 10.60, {"rid": 0}),
        (8, 0, "request.queue", 9.0, 10.20, {"rid": 0}),
        (11, 10, "page_table.put", 10.61, 10.62, {"puts": 1}),
        (10, 9, "page_table.reserve", 10.60, 10.65, {"gets": 2,
                                                     "puts": 1}),
        (13, 12, "page_table.export", 10.65, 10.70, {"rows": 3}),
        (14, 12, "page_table.get", 10.70, 10.75, {}),
        (12, 9, "page_table.lookup", 10.65, 10.75, {"keys": 8}),
        (15, 9, "model.decode", 10.75, 10.95, {}),
        (16, 9, "page_table.free", 10.95, 10.99, {"gets": 3,
                                                  "deletes": 3}),
        (9, 2, "engine.decode", 10.60, 11.00, {"rows": 2}),
        (2, 0, "engine.step", 10.10, 11.00, {}),
        (18, 17, "page_table.lookup", 12.00, 12.05, {}),
        (19, 17, "model.decode", 12.10, 12.40, {}),
        (17, 20, "engine.decode", 12.00, 12.50, {"rows": 2}),
        (21, 0, "request.queue", 15.0, 15.1, {"rid": 1}),
        (22, 0, "request.queue", 14.5, 15.0, {"rid": 2}),
        (23, 0, "request.queue", 20.5, 21.0, {"rid": 3}),     # after
    ]
    for sid, parent, name, t0, t1, tags in spans:
        ring._append((name, t0, t1, {"id": sid, "parent": parent, **tags}))
    return ring


def _run():
    return harness.Run({}, 1, 10.0, 20.0, [], [])


def _read(name, run):
    return harness.metric_reader(name)(run)


def test_readers_give_the_hand_worked_values(monkeypatch):
    monkeypatch.setattr(tm, "SPANS", _ring())
    run = _run()
    # the table's own calls: two prefill PUTs 0.05 s each, the page check
    # 0.05 s (its PUT inside it), two lookups 0.10 and 0.05 s, one free
    # 0.04 s; two decode steps
    assert _read("page_table_ms_per_step", run) == pytest.approx(
        (0.05 + 0.05 + 0.05 + 0.10 + 0.05 + 0.04) * 1e3 / 2)
    # PUTs 1 + 1 + 1, GETs 2 + 3, DELETEs 3
    assert _read("page_table_ops_per_step", run) == pytest.approx(11 / 2)
    assert _read("decode_launch_ms", run) == pytest.approx(
        (0.20 + 0.30) * 1e3 / 2)
    # waits 1.2, 0.1 and 0.5 s: p95 between the two largest
    assert _read("queue_wait_p95_ms", run) == pytest.approx(
        (0.5 + 0.9 * (1.2 - 0.5)) * 1e3)


def test_a_window_the_ring_dropped_from_reads_none(monkeypatch):
    ring = _ring(capacity=20)      # 22 spans: the second ends at 10.15
    assert ring.dropped == 2
    monkeypatch.setattr(tm, "SPANS", ring)
    assert all(_read(m, _run()) is None for m in READERS)
    ring = _ring(capacity=21)      # only the span before the window went
    monkeypatch.setattr(tm, "SPANS", ring)
    assert all(_read(m, _run()) is not None for m in READERS)


def test_a_program_without_the_ring_reads_none(monkeypatch):
    monkeypatch.delattr(tm, "SPANS")
    assert all(_read(m, _run()) is None for m in READERS)


def test_readers_on_a_smoke_run():
    c = smoke.cell("jamba-v0.1-52b")
    r, _ = smoke.run(c, 11, 2.0)
    read = {m: _read(m, r) for m in READERS}
    assert all(v is not None and v > 0 for v in read.values()), read
    steps = [s for s in r.steps if s.decode_s is not None]
    w = tm.SPANS.window(r.t0, r.t1)
    assert sum(1 for s in w if s.name == "engine.decode") == len(steps)
    assert read["decode_launch_ms"] < 1e3 * max(s.decode_s for s in steps)
