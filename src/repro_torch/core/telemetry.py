"""Unified telemetry: ONE metrics registry, log-bucketed latency
histograms and sampled per-request lifecycle tracing (port of
``repro.core.telemetry``, pure Python).

  * ``MetricsRegistry`` — counters, gauges and log-bucketed latency
    ``Histogram``s (p50/p95/p99/p999), plus registered *sources*: any
    object with a ``collect()`` method (or a zero-arg callable returning
    samples) is re-read at every ``collect()``/export, so snapshots are
    always current.  Every stats dataclass of the port (``SyncStats``,
    ``TreeStats``, ``PipelineStats``, ``CacheStats``, ``FeedStats``) and
    ``kernels/ops.py``'s read-dispatch meter speak that protocol, through
    ``samples_from``.
  * ``Tracer`` — sampled per-request ``Trace``s with spans across the
    ticket lifecycle (submit -> admit -> export_stage -> flip -> dispatch
    -> resolve), tagged with (shard, replica, epoch, serving_version) and
    kept in a bounded ring; sampling is deterministic (every
    ``round(1/rate)``-th request) and rate 0 builds no tracer at all.
  * Exporters — Prometheus text (``to_prometheus``, read back by
    ``parse_prometheus``/``prom_value``), a JSON snapshot, and Chrome
    trace-event JSON (``chrome_trace_events``, loadable in Perfetto).
  * ``SpanRing``/``SPANS`` — the process-wide ring of the serving path's
    spans (the engine's tick, prefill and decode, the page table's
    calls), each ``Span`` tagged with its id, its parent's id and its
    counts; the five names of ``PROFILER_RANGES`` also open a
    ``torch.profiler`` range while a capture is active.
    ``to_profiler_ns`` maps a ``CLOCK`` reading onto the profiler's host
    timeline (the Unix epoch), so ``SpanRing.chrome_trace`` lays the
    spans beside a profiler export.
  * ``Clock``/``CLOCK`` — THE injectable monotonic clock every timing site
    reads (shard, replica and scheduler alias it as ``_now``), and
    ``merge_stats``, the one aggregation path of the router and the
    replica group.

``HoneycombService`` (core/api.py) builds a ``Telemetry`` bundle from
``ServiceConfig.telemetry``, ``wire_store`` registers every stats surface
the facade exposes, and the scheduler records the GET/SCAN latency
histograms at dispatch and drives the tracer.  The metric names, their
labels and the histogram geometry (``buckets_per_decade`` geometric
buckets per decade over [lo, hi) plus under/overflow; a percentile is the
geometric midpoint of its rank's bucket clamped to the observed
[min, max]) are the reference's, so both packages export the same text
for the same meters.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import time
from collections import deque
from typing import Any, Callable, Iterable

from .config import TelemetryConfig

__all__ = [
    "CLOCK", "Clock", "Counter", "Gauge", "Histogram", "MetricSample",
    "MetricsRegistry", "OpenSpan", "PROFILER_RANGES",
    "SPANS", "SPAN_CAPACITY", "Span", "SpanRing", "Telemetry", "Trace",
    "Tracer", "chrome_trace_events", "merge_stats", "parse_prometheus",
    "profiler_offset_ns", "prom_value", "samples_from", "span",
    "timed_span", "to_profiler_ns",
]


class Clock:
    """THE injectable monotonic clock.  Calls through to
    ``time.perf_counter`` until frozen; a frozen clock returns a
    deterministic value that only ``advance()`` moves."""

    __slots__ = ("_frozen_at",)

    def __init__(self):
        self._frozen_at: float | None = None

    def __call__(self) -> float:
        at = self._frozen_at
        return time.perf_counter() if at is None else at

    now = __call__

    def freeze(self, at: float = 0.0) -> None:
        self._frozen_at = at

    def advance(self, dt: float) -> None:
        assert self._frozen_at is not None, "advance() needs a frozen clock"
        self._frozen_at += dt

    def unfreeze(self) -> None:
        self._frozen_at = None

    @contextlib.contextmanager
    def frozen(self, at: float = 0.0):
        """``with CLOCK.frozen(10.0): ...`` — deterministic time inside."""
        prev = self._frozen_at
        self.freeze(at)
        try:
            yield self
        finally:
            self._frozen_at = prev


#: The process-wide clock every timing site reads.  Freeze THIS to freeze
#: them all.
CLOCK = Clock()


@dataclasses.dataclass
class MetricSample:
    """One collected observation.  ``value`` is a float for counters and
    gauges and the ``Histogram`` object itself for histograms (exporters
    render quantiles/sum/count from it)."""
    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    value: Any
    labels: dict = dataclasses.field(default_factory=dict)

    def key(self) -> str:
        """Stable flat key: ``name{k=v,...}`` (name alone when unlabeled)."""
        if not self.labels:
            return self.name
        inner = ",".join(f"{k}={self.labels[k]}" for k in sorted(self.labels))
        return f"{self.name}{{{inner}}}"


def samples_from(obj, prefix: str, layer: str,
                 gauges: Iterable[str] = (),
                 derived: Iterable[str] = ()) -> list[MetricSample]:
    """The shared ``collect()`` implementation for the stats dataclasses:
    every numeric field becomes ``{prefix}_{field}`` (counter unless named
    in ``gauges``), and each ``derived`` property name is sampled as a
    gauge.  All samples carry ``layer=<layer>``."""
    out = []
    gauges = set(gauges)
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if not isinstance(v, (int, float)):
            continue
        kind = "gauge" if f.name in gauges else "counter"
        out.append(MetricSample(f"{prefix}_{f.name}", kind, float(v),
                                {"layer": layer}))
    for name in derived:
        out.append(MetricSample(f"{prefix}_{name}", "gauge",
                                float(getattr(obj, name)), {"layer": layer}))
    return out


def merge_stats(parts, factory):
    """Merge per-shard / per-replica stat objects into one ``factory()``.

    THE aggregation helper for every layer (``router.aggregate_stats`` is
    its alias): objects with a ``merge()`` method merge through it
    (``SyncStats`` maxes ``delta_fraction``, ``PipelineStats`` sums);
    plain dataclasses (``TreeStats``, ``CacheStats``, ``FeedStats``)
    field-sum."""
    agg = factory()
    if hasattr(agg, "merge"):
        for p in parts:
            agg.merge(p)
    else:
        for p in parts:
            for f in dataclasses.fields(agg):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(p, f.name))
    return agg


# -------------------------------------------------------------- instruments
class Counter:
    """Monotone accumulator (registry-owned; layer meters stay dataclasses
    and come in through ``collect()`` sources instead)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed latency histogram: geometric buckets over
    [``lo``, ``hi``) at ``buckets_per_decade`` resolution, plus
    underflow/overflow buckets.  See the module docstring for the accuracy
    contract; ``record(v, n)`` is weighted so a per-batch device time can
    be spread over the batch's requests with one call."""

    __slots__ = ("lo", "hi", "bpd", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, lo: float = 1e-7, hi: float = 1e3,
                 buckets_per_decade: int = 16):
        assert lo > 0 and hi > lo and buckets_per_decade >= 1
        self.lo, self.hi, self.bpd = lo, hi, buckets_per_decade
        n = int(math.ceil(math.log10(hi / lo) * buckets_per_decade))
        self.counts = [0] * (n + 2)      # [underflow] + n buckets + [overflow]
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return len(self.counts) - 1
        i = 1 + int(math.log10(v / self.lo) * self.bpd)
        return min(i, len(self.counts) - 2)

    def _bounds(self, i: int) -> tuple[float, float]:
        if i == 0:
            return 0.0, self.lo
        if i == len(self.counts) - 1:
            return self.hi, math.inf
        return (self.lo * 10.0 ** ((i - 1) / self.bpd),
                self.lo * 10.0 ** (i / self.bpd))

    def record(self, v: float, n: int = 1) -> None:
        if n <= 0:
            return
        self.counts[self._index(v)] += n
        self.count += n
        self.total += v * n
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def merge(self, other: "Histogram") -> None:
        assert (self.lo, self.hi, self.bpd) == \
            (other.lo, other.hi, other.bpd), "histogram geometry mismatch"
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` (0-100): geometric midpoint of the
        rank's bucket, clamped to the observed [min, max]."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                blo, bhi = self._bounds(i)
                if i == 0:
                    mid = self.vmin
                elif i == len(self.counts) - 1:
                    mid = self.vmax
                else:
                    mid = math.sqrt(blo * bhi)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantiles(self) -> dict:
        return {"p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "p999": self.percentile(99.9)}

    def to_dict(self) -> dict:
        out = {"count": self.count, "sum": self.total, "mean": self.mean,
               "min": self.vmin if self.count else 0.0,
               "max": self.vmax if self.count else 0.0}
        out.update(self.quantiles())
        return out


# ---------------------------------------------------------------- registry
class MetricsRegistry:
    """One registry per ``Telemetry`` bundle: owns its counters/gauges/
    histograms (get-or-create by (name, labels)) and any number of
    registered SOURCES — zero-arg callables returning either an object
    with ``collect()`` or an iterable of samples (``MetricSample`` or
    ``(name, kind, value[, labels])`` tuples, the dependency-free form
    kernels/ops.py uses).  Sources are re-invoked on every ``collect()``,
    so exports always reflect live meter state."""

    def __init__(self):
        self._own: dict[tuple, tuple[str, Any]] = {}
        self._sources: list[tuple[Callable[[], Any], dict]] = []

    # ------------------------------------------------------- instruments
    def _get(self, name: str, kind: str, make, labels: dict):
        key = (name, tuple(sorted(labels.items())))
        hit = self._own.get(key)
        if hit is None:
            hit = (kind, make())
            self._own[key] = hit
        assert hit[0] == kind, f"{name} already registered as {hit[0]}"
        return hit[1]

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, "counter", Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, "gauge", Gauge, labels)

    def histogram(self, name: str, lo: float = 1e-7, hi: float = 1e3,
                  buckets_per_decade: int = 16, **labels) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(lo, hi, buckets_per_decade),
                         labels)

    # ----------------------------------------------------------- sources
    def register(self, source, **labels) -> None:
        """Register a live stats source.  ``source`` is a zero-arg
        callable (preferred — re-read every collect) or an object with a
        ``collect()`` method; extra ``labels`` are stamped onto every
        sample it yields (e.g. ``src="scheduler"`` to keep two
        ``pipeline_*`` surfaces apart)."""
        fn = source if callable(source) else (lambda: source)
        self._sources.append((fn, labels))

    @staticmethod
    def _as_sample(x, extra: dict) -> MetricSample:
        if isinstance(x, MetricSample):
            s = x
        else:
            name, kind, value = x[0], x[1], x[2]
            labels = dict(x[3]) if len(x) > 3 else {}
            s = MetricSample(name, kind, value, labels)
        if extra:
            s = MetricSample(s.name, s.kind, s.value, {**s.labels, **extra})
        return s

    def collect(self) -> list[MetricSample]:
        out = []
        for (name, litems), (kind, inst) in self._own.items():
            value = inst if kind == "histogram" else inst.value
            out.append(MetricSample(name, kind, value, dict(litems)))
        for fn, extra in self._sources:
            got = fn()
            if got is None:
                continue
            if hasattr(got, "collect"):
                got = got.collect()
            for x in got:
                out.append(self._as_sample(x, extra))
        return out

    # --------------------------------------------------------- exporters
    def snapshot(self) -> dict:
        """JSON-able flat snapshot: ``{key: value}`` with histograms
        rendered to their count/sum/quantile dicts."""
        out = {}
        for s in self.collect():
            out[s.key()] = (s.value.to_dict()
                            if isinstance(s.value, Histogram) else s.value)
        return out

    def to_prometheus(self, prefix: str = "hc") -> str:
        """Prometheus text exposition (histograms as summaries)."""
        lines = []
        typed: set[str] = set()
        for s in self.collect():
            name = _prom_name(f"{prefix}_{s.name}")
            if isinstance(s.value, Histogram):
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} summary")
                h = s.value
                for q, pct in (("0.5", 50), ("0.95", 95), ("0.99", 99),
                               ("0.999", 99.9)):
                    lines.append(f"{name}{_prom_labels(s.labels, quantile=q)}"
                                 f" {h.percentile(pct):g}")
                lines.append(f"{name}_sum{_prom_labels(s.labels)}"
                             f" {h.total:g}")
                lines.append(f"{name}_count{_prom_labels(s.labels)}"
                             f" {h.count:g}")
            else:
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} {s.kind}")
                lines.append(f"{name}{_prom_labels(s.labels)} {s.value:g}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_labels(labels: dict, **extra) -> str:
    merged = {**labels, **extra}
    if not merged:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{merged[k]}"'
                     for k in sorted(merged))
    return "{" + inner + "}"


_PROM_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                        r"(?:\{(.*)\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> dict:
    """Parse the text exposition back into ``{name: [(labels, value)]}``
    — the reading half of the Prometheus round trip.  Raises
    ``ValueError`` on any non-comment line that does not parse."""
    out: dict[str, list] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(f"unparseable Prometheus line: {line!r}")
        name, rawlabels, raw = m.groups()
        labels = dict(_PROM_LABEL.findall(rawlabels)) if rawlabels else {}
        out.setdefault(name, []).append((labels, float(raw)))
    return out


def prom_value(parsed: dict, name: str, **labels) -> float:
    """Sum of every ``name`` series whose labels include ``labels``."""
    return sum(v for ls, v in parsed.get(name, ())
               if all(ls.get(k) == str(w) for k, w in labels.items()))


# ----------------------------------------------------------------- tracing
@dataclasses.dataclass
class Span:
    """One lifecycle stage of a traced request (``t0 == t1`` marks an
    instant event, e.g. submit/resolve)."""
    name: str
    t0: float
    t1: float
    tags: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Trace:
    """One sampled request's full lifecycle.  ``tags`` accumulates the
    response stamps at finish: shard, replica, epoch, serving_version,
    status."""
    rid: int
    kind: str
    t0: float
    t1: float = 0.0
    spans: list = dataclasses.field(default_factory=list)
    tags: dict = dataclasses.field(default_factory=dict)

    def span_names(self) -> list[str]:
        return [s.name for s in self.spans]


class Tracer:
    """Deterministic sampled request tracing: every ``round(1/rate)``-th
    submitted request gets a live ``Trace``; finished traces land in a
    bounded ring (``deque(maxlen=capacity)``).  The scheduler only calls
    in through ``is_live``/``span``/``span_all``, all of which are no-ops
    (and allocation-free) for unsampled rids."""

    def __init__(self, sample_rate: float, capacity: int = 256,
                 clock: Clock | None = None):
        assert 0.0 < sample_rate <= 1.0, "tracer needs a rate in (0, 1]"
        assert capacity >= 1
        self.period = max(1, round(1.0 / sample_rate))
        self.clock = clock or CLOCK
        self.sampled = 0
        self._seen = 0
        self._live: dict[int, Trace] = {}
        self.traces: deque[Trace] = deque(maxlen=capacity)

    @property
    def live_count(self) -> int:
        return len(self._live)

    def live_rids(self) -> list[int]:
        return list(self._live)

    def is_live(self, rid: int) -> bool:
        return rid in self._live

    def begin(self, rid: int, kind: str, **tags) -> Trace | None:
        """Sampling decision + submit instant; returns the live trace or
        None (the unsampled fast path allocates nothing)."""
        self._seen += 1
        if (self._seen - 1) % self.period:
            return None
        now = self.clock()
        t = Trace(rid=rid, kind=kind, t0=now, tags=dict(tags))
        t.spans.append(Span("submit", now, now))
        self._live[rid] = t
        self.sampled += 1
        return t

    def span(self, rid: int, name: str, t0: float, t1: float,
             **tags) -> None:
        t = self._live.get(rid)
        if t is not None:
            t.spans.append(Span(name, t0, t1, dict(tags) if tags else {}))

    def span_all(self, name: str, t0: float, t1: float, **tags) -> None:
        """Attach one span to every live trace (the export/flip stages
        cover the whole epoch, not one request)."""
        for t in self._live.values():
            t.spans.append(Span(name, t0, t1, dict(tags) if tags else {}))

    def finish(self, rid: int, **tags) -> Trace | None:
        t = self._live.pop(rid, None)
        if t is None:
            return None
        now = self.clock()
        t.spans.append(Span("resolve", now, now))
        t.tags.update(tags)
        t.t1 = now
        self.traces.append(t)
        return t

    def collect(self) -> list[tuple]:
        return [("traces_sampled", "counter", self.sampled,
                 {"layer": "tracer"}),
                ("traces_retained", "gauge", len(self.traces),
                 {"layer": "tracer"}),
                ("traces_live", "gauge", len(self._live),
                 {"layer": "tracer"})]


def _complete_event(s: Span, cat: str, pid: int, tid: int, args: dict,
                    ts_us: float) -> dict:
    """One Chrome complete ("ph": "X") event of span ``s``."""
    return {"name": s.name, "ph": "X", "cat": cat, "ts": ts_us,
            "dur": max((s.t1 - s.t0) * 1e6, 0.0), "pid": pid, "tid": tid,
            "args": args}


def chrome_trace_events(traces: Iterable[Trace]) -> dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing loadable):
    one complete ("ph": "X") event per span, pid = shard, tid = rid,
    timestamps in microseconds, tags in ``args``."""
    evs = []
    for t in traces:
        for s in t.spans:
            evs.append(_complete_event(
                s, t.kind, int(t.tags.get("shard", 0)), t.rid,
                {**t.tags, **s.tags, "rid": t.rid, "kind": t.kind},
                s.t0 * 1e6))
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


# ------------------------------------------------------- the span ring
#: The ring's size: a serving window of 50 s holds some 15-40 thousand
#: spans (10-30 a tick), so the window and the traced tail after it fit
#: with room to spare.
SPAN_CAPACITY = 1 << 18

#: The spans that also open a ``torch.profiler`` range while a capture is
#: active, under the same name: the serving engine's two phases and the
#: page table's three calls.  No other span does: a range that encloses
#: kernels is mirrored onto the device timeline, where an unknown name
#: would read as device activity.
PROFILER_RANGES = frozenset({"engine.prefill", "engine.decode",
                             "page_table.lookup", "page_table.put",
                             "page_table.free"})

_profiler = None          # torch.autograd.profiler, imported on first use


def _profiler_range(name: str):
    """An entered ``record_function(name)`` while a profiler capture is
    active, else None."""
    global _profiler
    if _profiler is None:
        from torch.autograd import profiler
        _profiler = profiler
    if not _profiler._is_profiler_enabled:
        return None
    rf = _profiler.record_function(name)
    rf.__enter__()
    return rf


_offset_ns: int | None = None


def profiler_offset_ns() -> int:
    """Nanoseconds from ``time.perf_counter``, which ``CLOCK`` reads, to
    the profiler's host clock, the Unix epoch (``time.time_ns``): read
    once, from the tightest of 32 back-to-back readings."""
    global _offset_ns
    if _offset_ns is None:
        best = None
        for _ in range(32):
            a = time.perf_counter_ns()
            wall = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, wall - (a + b) // 2)
        _offset_ns = best[1]
    return _offset_ns


def to_profiler_ns(t: float) -> int:
    """A ``CLOCK`` reading (seconds) on the profiler's timeline: the
    nanoseconds of ``start_ns()`` in ``kineto_results.events()``."""
    return round(t * 1e9) + profiler_offset_ns()


class OpenSpan:
    """One span while it runs: ``with`` opens and closes it.  Its id and
    the id of the span it opened inside (0 for none) go into ``tags``
    beside what the site tags; ``t0``/``t1`` are ``CLOCK`` readings."""

    __slots__ = ("ring", "name", "tags", "t0", "t1", "_range")

    def __init__(self, ring: "SpanRing", name: str, tags: dict):
        self.ring, self.name, self.tags = ring, name, tags

    def tag(self, **tags) -> None:
        self.tags.update(tags)

    def __enter__(self) -> "OpenSpan":
        ring = self.ring
        ring._next_id = sid = ring._next_id + 1
        tags = self.tags
        tags["id"] = sid
        tags["parent"] = ring._open
        ring._open = sid
        self._range = (_profiler_range(self.name)
                       if self.name in PROFILER_RANGES else None)
        self.t0 = ring.clock()
        return self

    def __exit__(self, *exc) -> None:
        ring = self.ring
        self.t1 = t1 = ring.clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        tags = self.tags
        ring._open = tags["parent"]
        ring._append((self.name, self.t0, t1, tags))


class _NoSpan:
    """What a site opens with telemetry off: records nothing."""

    __slots__ = ()

    def tag(self, **tags) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Timer(_NoSpan):
    """What a timed site opens with telemetry off: records nothing, but
    reads ``CLOCK`` at its ends."""

    __slots__ = ("t0", "t1")

    def __enter__(self) -> "_Timer":
        self.t0 = CLOCK()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = CLOCK()


class SpanRing:
    """The program's spans, newest last, in a bounded ring that drops the
    oldest.  Spans are appended as they close, so the ring runs in order
    of ``t1``; ``dropped`` counts what fell out and ``dropped_t1`` is the
    latest end among it, so a reader knows whether a window is whole.
    A span is kept as the plain tuple ``(name, t0, t1, tags)``, the least
    a site pays to record it; ``window`` and ``spans`` hand them out as
    ``Span``s."""

    def __init__(self, capacity: int = SPAN_CAPACITY,
                 clock: Clock | None = None):
        assert capacity >= 1
        self._ring: deque[tuple] = deque(maxlen=capacity)
        self.clock = clock or CLOCK
        self.dropped = 0
        self.dropped_t1 = -math.inf
        self._next_id = 0               # the last id given
        self._open = 0                  # the id of the innermost open span

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def __len__(self) -> int:
        return len(self._ring)

    def spans(self) -> list[Span]:
        """Every span held, oldest end first."""
        return [Span(*s) for s in self._ring]

    def add(self, name: str, t0: float, t1: float, **tags) -> None:
        """A span timed elsewhere (``request.queue``), with no parent."""
        self._next_id = sid = self._next_id + 1
        self._append((name, t0, t1, {"id": sid, "parent": 0, **tags}))

    def _append(self, span: tuple) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
            self.dropped_t1 = max(self.dropped_t1, ring[0][2])
        ring.append(span)

    def window(self, t0: float, t1: float) -> list[Span] | None:
        """The spans that end in (``t0``, ``t1``], or None where the ring
        dropped any of them."""
        if self.dropped_t1 > t0:
            return None
        return [Span(*s) for s in self._ring if t0 < s[2] <= t1]

    def clear(self) -> None:
        self._ring.clear()
        self.dropped, self.dropped_t1 = 0, -math.inf

    def collect(self) -> list[tuple]:
        lab = {"layer": "spans"}
        return [("spans_held", "gauge", len(self._ring), lab),
                ("spans_dropped", "counter", self.dropped, lab)]

    def chrome_trace(self, base_ns: int = 0) -> dict:
        """The ring as Chrome trace-event JSON on the profiler's timeline:
        ``ts`` in microseconds from ``base_ns`` on the Unix epoch.  Given
        the ``baseTimeNanoseconds`` of a ``prof.export_chrome_trace``
        file, its events and these share one time axis, so the two
        ``traceEvents`` lists concatenated load as one Perfetto view.
        The ticks' spans nest on pid 0, tid 0; each request's queue wait
        is on pid 1, tid = its rid."""
        evs = []
        for s in self.spans():
            rid = s.tags.get("rid", 0)
            pid, tid = (1, rid) if s.name == "request.queue" else (0, 0)
            evs.append(_complete_event(
                s, s.name.split(".")[0], pid, tid, dict(s.tags),
                (to_profiler_ns(s.t0) - base_ns) / 1e3))
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": base_ns}


#: The process-wide span ring the serving path records into
#: (``ServingEngine(telemetry=...)``) and the benchmark reads.
SPANS = SpanRing()


def span(ring: SpanRing | None, name: str, **tags):
    """``with span(ring, name, **tags) as sp:`` at a site whose ring is
    None with telemetry off (the one ``is None`` branch of the site)."""
    return _NO_SPAN if ring is None else OpenSpan(ring, name, tags)


def timed_span(ring: SpanRing | None, name: str, **tags):
    """``span`` at a site that times itself by its span: with telemetry
    off it records nothing but still reads ``CLOCK`` at its ends, so
    ``sp.t1 - sp.t0`` is the site's seconds either way."""
    return _Timer() if ring is None else OpenSpan(ring, name, tags)


# ------------------------------------------------------------------ bundle
class Telemetry:
    """Registry + (optional) tracer behind one handle, with the wiring
    helpers the service layer uses.  Constructed by ``HoneycombService``
    from ``ServiceConfig.telemetry`` when enabled; standalone use is one
    line: ``tm = Telemetry(); tm.wire_store(store)``."""

    def __init__(self, cfg: TelemetryConfig | None = None,
                 clock: Clock | None = None):
        self.cfg = cfg or TelemetryConfig()
        self.clock = clock or CLOCK
        self.registry = MetricsRegistry()
        self.tracer = (Tracer(self.cfg.trace_sample_rate,
                              self.cfg.trace_capacity, self.clock)
                       if self.cfg.trace_sample_rate > 0 else None)
        if self.tracer is not None:
            self.registry.register(self.tracer.collect)

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    def histogram(self, name: str, **labels) -> Histogram:
        return self.registry.histogram(
            name, lo=self.cfg.latency_lo, hi=self.cfg.latency_hi,
            buckets_per_decade=self.cfg.buckets_per_decade, **labels)

    # ------------------------------------------------------------ wiring
    def wire_store(self, store) -> "Telemetry":
        """Register every stats surface the facade exposes.  Probes by
        meter property name, so it works across the whole facade family
        (``StoreShard``/``HoneycombStore``, ``ShardedHoneycombStore``,
        bare ``ReplicaGroup``) — absent surfaces are skipped."""
        reg = self.registry
        reg.register(lambda: store.sync_stats, src="primary")
        reg.register(lambda: store.stats)                     # TreeStats
        if hasattr(store, "pipeline_stats"):
            reg.register(lambda: store.pipeline_stats, src="store")
        if hasattr(store, "cache_stats"):
            reg.register(lambda: store.cache_stats)
        if hasattr(store, "feed_stats"):
            reg.register(lambda: store.feed_stats)
            reg.register(lambda: store.replication_stats, src="followers")
        # EpochSan meters, when the sanitizer is active (lazy import: the
        # registry must stay constructible without the analysis package)
        from ..analysis import epochsan as _epochsan
        san = _epochsan.get()
        if san is not None:
            reg.register(lambda: san.stats)
        self.wire_kernel_meter()
        return self

    def wire_scheduler(self, sched) -> "Telemetry":
        self.registry.register(lambda: sched.stats, src="scheduler")

        def _sched_meters():
            lab = {"layer": "scheduler"}
            return [
                ("scheduler_dispatched_batches", "counter",
                 sched.dispatched_batches, lab),
                ("scheduler_dispatched_requests", "counter",
                 sched.dispatched_requests, lab),
                ("scheduler_applied_writes", "counter",
                 sched.applied_writes, lab),
                ("scheduler_syncs", "counter", sched.syncs, lab),
            ]
        self.registry.register(_sched_meters)
        return self

    def wire_kernel_meter(self) -> None:
        """The READ_DISPATCHES launch counter (kernels/ops.py).  Imported
        at collect time: kernels/ops.py imports core modules, so this
        module may not import it at load."""
        def _kernel_samples():
            from ..kernels import ops as kernel_ops
            return kernel_ops.collect()
        self.registry.register(_kernel_samples)

    # --------------------------------------------------------- exporters
    def collect(self) -> list[MetricSample]:
        return self.registry.collect()

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def to_prometheus(self, prefix: str = "hc") -> str:
        return self.registry.to_prometheus(prefix)

    def traces(self) -> list[Trace]:
        return list(self.tracer.traces) if self.tracer is not None else []

    def chrome_trace(self) -> dict:
        return chrome_trace_events(self.traces())

    # ------------------------------------------------------------ lookup
    def value(self, name: str, **labels) -> float:
        """Sum of every matching counter/gauge sample, so a report reads
        the registry, not the layer dataclasses."""
        tot = 0.0
        for s in self.collect():
            if s.name == name and not isinstance(s.value, Histogram) and \
                    all(s.labels.get(k) == v for k, v in labels.items()):
                tot += s.value
        return tot

    def quantile(self, name: str, p: float, **labels) -> float:
        """Percentile ``p`` over every matching histogram (merged)."""
        merged = None
        for s in self.collect():
            if s.name == name and isinstance(s.value, Histogram) and \
                    all(s.labels.get(k) == v for k, v in labels.items()):
                if merged is None:
                    merged = Histogram(s.value.lo, s.value.hi, s.value.bpd)
                merged.merge(s.value)
        return merged.percentile(p) if merged is not None else 0.0

    def summary(self) -> dict:
        """Flat JSON-able registry view keyed ``name{labels}`` (scalars
        verbatim, histograms as quantile dicts) — what the benchmarks
        attach next to their results."""
        return self.registry.snapshot()
