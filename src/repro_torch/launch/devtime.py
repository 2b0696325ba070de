"""Device time from torch.profiler's trace, for ``chip_smoke.py`` and the
store dry run's pipeline stages (``launch/store_dryrun.py``).

The profiler keeps only the device activities inside its capture range,
and it places them on the host's clock; that placement has been seen
shifted earlier by milliseconds, so the first launches of an unguarded
trace fell before the range and were lost
(``scripts/torch_profiler_drops.py`` measures it).  Every trace here opens
``TRACE_GUARD_S`` of idle before its window and closes as long after it.
A trace that still lost activities is taken again.  Needs a card: on the
CPU nothing is timed.
"""
from __future__ import annotations

import time

import torch

TRACE_GUARD_S = 0.05    # idle traced before and after a timed window
WINDOW = "timed_window"  # the annotation around the timed calls


def device_events_raw(fn, guard_s: float = TRACE_GUARD_S):
    """Run ``fn`` under torch.profiler, inside a ``WINDOW`` annotation,
    and return the trace's events.  The trace opens ``guard_s`` before
    the window, with the device idle, and closes as long after it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(guard_s)
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        time.sleep(guard_s)
    return prof.events()


def device_events(fn):
    """Run ``fn`` under torch.profiler.  Returns the (name, microseconds)
    of every device activity (kernel, copy, set) it caused, and the
    microseconds of the whole window on the host's clock."""
    from torch.autograd import DeviceType
    evs = device_events_raw(fn)
    window = next(e.time_range.elapsed_us() for e in evs
                  if e.name == WINDOW)
    # the window's own annotation is mirrored onto the device's timeline
    return [(e.name, e.time_range.elapsed_us()) for e in evs
            if e.device_type == DeviceType.CUDA and e.name != WINDOW], window


def by_name(events) -> dict:
    """{name: (count, total microseconds)} of (name, microseconds) pairs."""
    by = {}
    for name, t in events:
        n, tot = by.get(name, (0, 0.0))
        by[name] = (n + 1, tot + t)
    return by


_FILL_NAMES = {}    # id(flush) -> the names of its fill kernels


def device_all_ms(fns: list, reps: int, flush: torch.Tensor,
                  need: dict | None = None, min_traced: float = 0.9,
                  tries: int = 3) -> tuple[float, dict]:
    """Mean device time per call of EVERY device activity that ``fns``
    cause (a library call may launch several kernels), cycling through
    ``fns`` for ``reps`` calls, with ``flush`` (larger than the 50 MB L2)
    overwritten before each call, because a main path finds its data
    cold; the flush's own fill is told apart by its name and left out.
    A trace holding fewer than ``min_traced`` of the fills, or of the
    activities ``need`` names ({name fragment: count a call}), is taken
    again, up to ``tries`` traces; then this raises.  The mean is over
    the calls whose fill the trace holds.  Returns (ms, ``by_name`` of the
    calls' activities)."""
    # the flush's fill kernels by name, probed once a flush tensor (every
    # trace is one more chance for the profiler to drop events); a probe
    # trace that the profiler dropped whole is taken again
    fill = _FILL_NAMES.get(id(flush), set())
    for _ in range(tries):
        if fill:
            break
        fill = {name for name, _ in device_events(
            lambda: [flush.fill_(r) for r in range(8)])[0]}
    if not fill:
        raise RuntimeError(f"the profiler traced no flush fill, in each of "
                           f"{tries} traces")
    _FILL_NAMES[id(flush)] = fill
    for fn in fns:
        fn()

    def run():
        for r in range(reps):
            flush.fill_(r)
            fns[r % len(fns)]()
    for _ in range(tries):
        evs = device_events(run)[0]
        fills = sum(1 for name, _ in evs if name in fill)
        mine = [(name, t) for name, t in evs if name not in fill]
        held = all(sum(1 for name, _ in mine if frag in name)
                   >= min_traced * reps * k
                   for frag, k in (need or {}).items())
        if fills >= reps * min_traced and held:
            return sum(t for _, t in mine) / fills / 1e3, by_name(mine)
    top = sorted(by_name(evs).items(), key=lambda x: -x[1][1])[:12]
    raise RuntimeError(
        f"the profiler traced {fills} of {reps} calls, or lost activities of "
        f"{sorted(need or {})}, in each of {tries} traces; the flush's fills "
        f"{sorted(fill)}; the last trace's activities {top}")
