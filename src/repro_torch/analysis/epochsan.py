"""EpochSan — runtime sanitizer for the epoch/snapshot pipeline (port of
``repro.analysis.epochsan``).

The double-buffered snapshot protocol (core/shard.py, core/replica.py)
carries happens-before rules no type system enforces: a device batch may
only read a snapshot that was *flipped* (published), garbage may only be
reclaimed once every pinned accelerator epoch has moved past it, a
follower may only serve a batch when its published read version covers
the primary's, and a snapshot staged after a ``PageTable`` remap must
carry a refreshed interior-cache frontier.  Each of these was a runtime
bug class once (see the rule table in ``analysis/__init__``); EpochSan
turns them into checked invariants.

Activation is environment-gated so the hooks cost one module-attribute
read + ``is None`` test when off::

    HONEYCOMB_EPOCHSAN=1 python -m pytest -q

or programmatically (tests)::

    from repro_torch.analysis import epochsan
    with epochsan.enabled():
        ...

The sanitizer tags every snapshot buffer it sees at a staging/flip seam
with ``(epoch, pin-state, role)`` (role is ``standby`` until the flip
publishes it as ``active``; earlier actives retire).  Detection itself
never trusts the tags alone — the standby-read check compares *object
identity* against every live owner's ``_standby`` attribute, the GC
audit re-derives reclaimability from the pre-collect epoch window, and
the freshness check recomputes the read-version comparison — so a seam
that lies (the bug the sanitizer exists to catch) cannot also silence
the check.

This module deliberately imports nothing from ``repro_torch.core`` at module
scope: core modules import *it* for the seam hooks, and the telemetry
bridge (``EpochSanStats.collect``) resolves lazily at collect time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import weakref
from typing import NamedTuple

ENV_VAR = "HONEYCOMB_EPOCHSAN"

#: violation kinds, for reports and tests
STANDBY_READ = "standby-read"
PINNED_EPOCH_GC = "pinned-epoch-gc"
FOLLOWER_FRESHNESS = "follower-freshness"
STALE_CACHE_ROWS = "stale-cache-rows"
UNFLIPPED_EXPORT = "unflipped-standby-after-export"


class EpochSanViolation(AssertionError):
    """An epoch/snapshot protocol invariant was broken at a checked seam."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"[epochsan:{kind}] {message}")
        self.kind = kind


@dataclasses.dataclass
class EpochSanStats:
    """Sanitizer meters (telemetry collect protocol — registered by
    ``Telemetry.wire_store`` when the sanitizer is active)."""
    read_checks: int = 0
    stagings: int = 0
    flips: int = 0
    gc_audits: int = 0
    dispatch_checks: int = 0
    violations: int = 0

    def collect(self):
        from ..core.telemetry import samples_from
        return samples_from(self, "epochsan", "epochsan")


class SnapshotTag(NamedTuple):
    """What the sanitizer knows about one snapshot buffer."""
    epoch: int
    role: str                  # "standby" | "active" | "retired"
    read_version: int | None
    pinned: bool               # an accelerator epoch pin covers it


@dataclasses.dataclass
class _GcGuard:
    """Pre-collect capture of the garbage list and the epoch window the
    reclaimability decision must be audited against."""
    entries: list
    cpu_seq: dict
    accel_s_old: int


class EpochSanitizer:
    """The active sanitizer: owns tags, owner registry, cache ticks and
    the violation log.  ``strict=True`` raises on the first violation;
    ``strict=False`` records only (the findings-report mode)."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        self.stats = EpochSanStats()
        self.violations: list[EpochSanViolation] = []
        # owners (StoreShard / FollowerReplica) whose ``_standby`` the
        # read check scans by identity; weak so the sanitizer never keeps
        # a store alive
        self._owners: weakref.WeakSet = weakref.WeakSet()
        # id(snapshot) -> tag; informational (identity checks decide)
        self._tags: dict[int, SnapshotTag] = {}
        # per-InteriorCache remap/refresh ticks for the stale-rows check
        self._cache_ticks: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()

    # ------------------------------------------------------------ report
    def _violate(self, kind: str, message: str):
        self.stats.violations += 1
        err = EpochSanViolation(kind, message)
        self.violations.append(err)
        if self.strict:
            raise err

    def report(self) -> list[dict]:
        return [{"kind": v.kind, "message": str(v)} for v in self.violations]

    # ----------------------------------------------------- staging seams
    def note_staged(self, owner, snap) -> None:
        """A standby was (re)staged on ``owner`` (shard or follower)."""
        if snap is None:
            return
        self.stats.stagings += 1
        self._owners.add(owner)
        pinned = getattr(owner, "_standby_pin", None) is not None
        self._tags[id(snap)] = SnapshotTag(
            epoch=getattr(owner, "epoch", 0) + 1, role="standby",
            read_version=getattr(owner, "_standby_rv", None), pinned=pinned)
        cache = getattr(owner, "cache", None)
        if cache is not None:
            self._check_cache_fresh(owner, cache)

    def note_flip(self, owner, snap) -> None:
        """The standby was published as ``owner``'s active snapshot."""
        if snap is None:
            return
        self.stats.flips += 1
        self._owners.add(owner)
        old = self._tags.get(id(snap))
        self._tags[id(snap)] = SnapshotTag(
            epoch=getattr(owner, "epoch", old.epoch if old else 0),
            role="active",
            read_version=getattr(owner, "snapshot_rv", None)
            or getattr(owner, "_snapshot_rv", None),
            pinned=getattr(owner, "_snapshot_pin", None) is not None)

    # -------------------------------------------------------- read seams
    def check_read(self, dispatcher, snap) -> None:
        """A device batch is about to execute against ``snap``.  The
        snapshot must not be any live owner's unflipped standby."""
        self.stats.read_checks += 1
        if snap is None:
            return
        for owner in list(self._owners):
            if getattr(owner, "_standby", None) is snap:
                tag = self._tags.get(id(snap))
                self._violate(
                    STANDBY_READ,
                    f"device batch dispatched against the UNFLIPPED standby "
                    f"of {type(owner).__name__} (tag={tag}); reads must only "
                    f"see snapshots published by flip()")

    def check_follower_dispatch(self, group, follower) -> None:
        """A batch resolved to ``follower``; recompute the freshness rule
        independently of ``ReplicaGroup._covers`` (the seam under test)."""
        self.stats.dispatch_checks += 1
        need = getattr(group.primary, "_snapshot_rv", None)
        if need is None:
            return
        got = getattr(follower, "snapshot_rv", None)
        if follower.snapshot is None or got is None or got < need:
            self._violate(
                FOLLOWER_FRESHNESS,
                f"replica {follower.replica_id} dispatched at read version "
                f"{got} but the group serves at {need}: the freshness rule "
                f"(follower covers the primary's active snapshot) is broken")

    def check_exported(self, store) -> None:
        """After a scheduler ``stage_export`` every staged standby must
        have been flipped: primary always, followers when unpaused and in
        sync (exactly the set ``_on_primary_flip`` publishes)."""
        shards = getattr(store, "shards", None) or [store]
        for s in shards:
            prim = getattr(s, "primary", s)
            if getattr(prim, "_standby", None) is not None:
                self._violate(
                    UNFLIPPED_EXPORT,
                    f"shard {getattr(prim, 'shard_id', '?')} left "
                    f"stage_export with a staged, unpublished standby")
            for f in getattr(s, "followers", ()) or ():
                if not f.paused and f.in_sync and f._standby is not None:
                    self._violate(
                        UNFLIPPED_EXPORT,
                        f"replica {f.replica_id} (in sync, unpaused) left "
                        f"stage_export with an unpublished standby")

    # ---------------------------------------------------------- GC seams
    def gc_begin(self, shard) -> _GcGuard:
        ep = shard.tree.epochs
        return _GcGuard(entries=list(shard.tree.gc.list),
                        cpu_seq=dict(ep.cpu_seq),
                        accel_s_old=ep.accel_s_old)

    def gc_end(self, shard, guard: _GcGuard) -> None:
        """Audit one ``collect()``: every entry it freed must have been
        reclaimable under the PRE-collect epoch window (no pinned epoch —
        accelerator or CPU thread — may lose its buffers)."""
        self.stats.gc_audits += 1
        remaining = {id(e) for e in shard.tree.gc.list}
        for e in guard.entries:
            if id(e) in remaining:
                continue
            cpu_pinned = any(guard.cpu_seq.get(t, 0) <= s
                             for t, s in e.cpu_stamp.items())
            accel_pinned = guard.accel_s_old <= e.accel_stamp
            if cpu_pinned or accel_pinned:
                self._violate(
                    PINNED_EPOCH_GC,
                    f"GC reclaimed slots {e.slots} stamped S={e.accel_stamp} "
                    f"while the accelerator window still pins "
                    f"S_old={guard.accel_s_old}"
                    + (" (CPU thread pinned too)" if cpu_pinned else "")
                    + "; a pinned epoch's buffers were freed under it")

    # -------------------------------------------------------- cache seams
    def note_cache_invalidate(self, cache) -> None:
        t = self._cache_ticks.setdefault(cache, {"inval": 0, "at_refresh": 0})
        t["inval"] += 1

    def note_cache_refresh(self, cache) -> None:
        t = self._cache_ticks.setdefault(cache, {"inval": 0, "at_refresh": 0})
        t["at_refresh"] = t["inval"]

    def _check_cache_fresh(self, owner, cache) -> None:
        """At staging time the interior cache must have been refreshed
        after the last ``PageTable`` remap invalidation — otherwise the
        staged snapshot ships stale cache rows to the device."""
        t = self._cache_ticks.get(cache)
        if t is not None and t["inval"] > t["at_refresh"]:
            self._violate(
                STALE_CACHE_ROWS,
                f"{type(owner).__name__} staged a snapshot while the "
                f"interior cache saw {t['inval'] - t['at_refresh']} remap "
                f"invalidation(s) after its last refresh: stale cache rows "
                f"would survive the PageTable remap on-device")


# --------------------------------------------------------------- gating
_ACTIVE: EpochSanitizer | None = None
_ENV_CHECKED = False


def get() -> EpochSanitizer | None:
    """The active sanitizer, or None.  Reads ``HONEYCOMB_EPOCHSAN`` once
    (first seam hit); ``enabled()``/``enable()`` override it for tests."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        if os.environ.get(ENV_VAR, "").strip() not in ("", "0", "false"):
            _ACTIVE = EpochSanitizer()
    return _ACTIVE


def enable(strict: bool = True) -> EpochSanitizer:
    global _ACTIVE, _ENV_CHECKED
    _ENV_CHECKED = True
    _ACTIVE = EpochSanitizer(strict=strict)
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def enabled(strict: bool = True):
    """Scoped activation for tests: ``with epochsan.enabled() as san:``."""
    global _ACTIVE
    prev = get()   # resolve the env-driven sanitizer before overriding
    san = enable(strict=strict)
    try:
        yield san
    finally:
        _ACTIVE = prev
