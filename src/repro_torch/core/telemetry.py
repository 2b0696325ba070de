"""Telemetry primitives the stats dataclasses need (port of part of
``repro.core.telemetry``).

``Clock``/``CLOCK`` is THE injectable monotonic clock every timing site
reads (core/shard.py aliases it as ``_now``), and ``samples_from`` is the
shared ``collect()`` implementation of ``SyncStats``, ``TreeStats``,
``PipelineStats``, ``CacheStats`` and ``FeedStats``; ``merge_stats`` is
the one aggregation path the router and the replica group use.  The
metrics registry, histograms, tracer and exporters come with the service
layer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Iterable

__all__ = ["CLOCK", "Clock", "MetricSample", "merge_stats", "samples_from"]


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
    """One collected observation (counters and gauges carry a float)."""
    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    value: Any
    labels: dict = dataclasses.field(default_factory=dict)


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
