"""The traced tail: the closed loop run on under torch.profiler after the
measured window, and what the trace says.

The profiler places device activity on the host's clock, and has been
seen to place it milliseconds early, so that the first launches of an
unguarded trace fell outside its range and were lost.  As
``repro_torch/launch/devtime.py`` does, the trace opens ``GUARD_S`` of
idle before its window and closes as long after it.

The engine's phases and the page table's calls are wrapped in profiler
ranges for the tail only: ``engine.prefill``, ``engine.decode``,
``page_table.lookup`` (the decode step's block-table GET), ``page_table.put``
(a page allocated) and ``page_table.free`` (a finished request's pages).
A device activity belongs to a range when the runtime call that launched
it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...; the profiler gives the
call and its activity one correlation id) ran inside that range on the
host.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import torch

GUARD_S = 0.05
WINDOW = "bench.window"
RANGES = {"engine.prefill": ("engine", "_prefill_one"),
          "engine.decode": ("engine", "_decode_batch"),
          "page_table.lookup": ("kv", "lookup_block_tables"),
          "page_table.put": ("kv", "allocate"),
          "page_table.free": ("kv", "free_seq")}


@dataclasses.dataclass
class Trace:
    window_us: float
    busy_us: float
    kernels: dict          # device activity name -> (count, us)
    range_device_us: dict  # range name -> us of the activities it launched
    idle_gaps: list        # [(what the host ran, us)], longest first


def _wrap(obj, method: str, label: str):
    from torch.profiler import record_function
    inner = getattr(obj, method)

    def traced(*args, **kwargs):
        with record_function(label):
            return inner(*args, **kwargs)
    setattr(obj, method, traced)
    return lambda: delattr(obj, method)


def trace_tail(loop, engine, seconds: float):
    """Run ``loop`` on for ``seconds`` under the profiler.  Returns the
    ``Trace`` and the steps it ran."""
    from torch.profiler import ProfilerActivity, profile, record_function
    owners = {"engine": engine, "kv": engine.kv}
    undo = [_wrap(owners[o], m, label) for label, (o, m) in RANGES.items()]
    steps = []
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(GUARD_S)
            with record_function(WINDOW):
                loop.run_until(time.perf_counter() + seconds, steps)
                torch.cuda.synchronize()
            time.sleep(GUARD_S)
    finally:
        for u in undo:
            u()
    return analyse(prof.profiler.kineto_results.events()), steps


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(events) -> Trace:
    """The ``Trace`` of the profiler's raw events (``kineto_results.
    events()``: ``name()``, ``device_type()``, ``start_ns()``,
    ``end_ns()``, ``correlation_id()``), read without building the
    profiler's event tree, which takes minutes at this many events."""
    from torch.autograd import DeviceType
    cpu, dev = [], []
    names = set(RANGES) | {WINDOW}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            cpu.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                        e.correlation_id()))
        elif e.device_type() == DeviceType.CUDA and e.name() not in names:
            dev.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                        e.correlation_id()))
    window = [(s, t) for s, t, name, _ in cpu if name == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} windows")
    (w0, w1), = window
    if not dev:
        raise RuntimeError("the trace holds no device activity")
    kernels = {}
    for s, t, name, _ in dev:
        n, us = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, us + t - s)
    merged = _union((s, t) for s, t, _, _ in dev)
    busy = sum(t - s for s, t in merged)

    # the ranges at two levels, neither overlapping itself: the page
    # table's calls, and the engine's phases around them
    levels = []
    for prefix in ("page_table.", "engine."):
        rs = sorted((s, t, name) for s, t, name, _ in cpu
                    if name.startswith(prefix) and name in RANGES)
        levels.append((rs, [r[0] for r in rs]))

    def inside(t):
        """The innermost range that holds host time ``t``, or None."""
        for rs, starts in levels:
            at = bisect.bisect_right(starts, t) - 1
            if at >= 0 and t <= rs[at][1]:
                return rs[at][2]
        return None

    # device activity by the range its runtime call ran in
    owner = {corr: inside(s) for s, _, name, corr in cpu
             if corr and name.startswith("cu")}
    range_us = {name: 0.0 for name in RANGES}
    for s, t, _, corr in dev:
        if owner.get(corr):
            range_us[owner[corr]] += t - s

    # the longest idle stretches inside the window, by the range the
    # host was in at their middle
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:])
                   if w0 <= a[1] and b[0] <= w1), reverse=True)
    idle = [(inside(mid) or "host outside the engine's calls", us)
            for us, mid in gaps[:10]]
    return Trace(w1 - w0, busy, kernels, range_us, idle)
