"""Request scheduling: out-of-order, shard-aware, epoch-pipelined batch
composition (paper Sections 4.1 and 3-4, lifted to the sharded stack;
port of ``repro.core.scheduler``).

The FPGA avoids head-of-line blocking by letting requests complete out of
order.  A device batch advances in lock step, so the equivalent
straggler mitigation is *batch composition*: read requests are
bucketed by ``(shard, replica, kind, cost_class)`` — owning range-shard
first, then the replica the store's read-spreading policy assigned
(core/replica.py; replica 0 — the primary — when the store is not
replicated), then expected work (scan width) — so a vectorized step is
neither held hostage by one expensive lane nor scattered across device
snapshots, and responses are re-ordered back to arrival order on
completion: out-of-order execution with in-order delivery, exactly the
accelerator's contract.

Requests are TYPED OPS (core/api.py): ``submit_op`` takes a ``Get`` /
``Scan`` / ``Put`` / ``Update`` / ``Delete`` message and the internal
``Request`` is a thin envelope — rid + op + routing pins (shard, replica).
The stringly ``submit(kind, key, ...)`` facade remains as a shim that
builds the op and delegates, so both APIs share ONE execution path
(op-for-op identical, including sync byte counts).  Routing comes
from the STORE — pass ``routing=store.routing()`` (the ``HoneycombService``
wires it automatically); callers no longer thread ``shard_of`` /
``replica_of`` callbacks by hand.  With no routing, everything buckets to
shard 0, which reproduces the unsharded behaviour exactly.

Writes are first-class requests too.  One ``run()`` performs the serving
stack's full cycle as three EXPLICIT pipeline stages:

  1. ``stage_admit``   — apply every pending write host-side, in submission
     order, routed to its owning shard (automatic per-shard policy syncs
     deferred for the burst);
  2. ``stage_export``  — ONE host->device delta sync per DIRTY shard — the
     paper's batched synchronization, per device;
  3. ``stage_dispatch`` — dense per-shard read batches
     (``ready_batches()`` is the single source of dispatch order — run()
     consumes it, so the two can never disagree).

``pipeline`` selects how the stages compose:

  * ``"serial"`` (default) — one facade ``export_snapshot()`` covering
    every dirty shard, then a wait for the device to finish the sync
    (``torch.cuda.synchronize`` on each CUDA device the synced snapshots
    lie on; nothing for CPU tensors, which are ready when returned)
    before any read dispatches; the wait is metered as
    ``stats.sync_stall_s``.
  * ``"pipelined"`` — double-buffered epochs: every dirty shard's delta is
    STAGED into its standby (the scatter launches are only enqueued on the
    current stream), each shard flips independently, and read batches
    dispatch without waiting.  Results and sync byte counts are identical
    to serial mode by construction (reads always execute against the
    flipped epoch).

``run_ops()`` resolves every request to a stamped ``Response`` (status,
value/items, the serving replica, and the read version the answering
snapshot served at — the linearizability stamp); ``run()`` is the shim
that unwraps responses to bare values.

EpochSan (``analysis/epochsan.py``) checks at the end of
``stage_export`` that every staged standby was flipped.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Iterable, Sequence

import torch

from ..analysis import epochsan as _epochsan
from .api import NOT_FOUND, OK, OPS_BY_KIND, Op, Response, Routing, Scan
from .pipeline import PIPELINE_MODES, PipelineStats
from .telemetry import CLOCK

_now = CLOCK            # THE injectable monotonic clock (core/telemetry.py)


@dataclasses.dataclass
class Request:
    """Thin envelope around one submitted op: the sequence number plus the
    routing pins (owning shard; replica assigned at submit so batches stay
    replica-homogeneous).  The legacy field views (kind/key/hi/value/
    expected_items) read through to the op."""
    rid: int
    op: Op
    shard: int = 0
    replica: int = 0           # replica the read is pinned to (0 = primary)

    @property
    def kind(self) -> str:
        return self.op.KIND

    @property
    def key(self) -> bytes:
        return self.op.route_key

    @property
    def hi(self) -> bytes:
        return getattr(self.op, "hi", b"")

    @property
    def value(self) -> bytes:
        return getattr(self.op, "value", b"")

    @property
    def expected_items(self) -> int:
        return self.op.expected_items


def _block_until_ready(snaps) -> None:
    """Wait for the device work behind ``snaps`` (one snapshot, a list of
    them, or None): ``torch.cuda.synchronize`` once per CUDA device they
    lie on; CPU tensors are ready when returned."""
    devices = set()
    for snap in snaps if isinstance(snaps, list) else [snaps]:
        for x in snap or ():
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    devices.add(x.device)
                break
    for d in devices:
        torch.cuda.synchronize(d)


class OutOfOrderScheduler:
    """Buckets read ops by (shard, replica, kind, cost class), queues
    writes in order, runs the admit/export/dispatch pipeline stages,
    reassembles stamped responses in arrival order."""

    def __init__(self, batch_size: int = 256,
                 cost_classes: Sequence[int] = (1, 4, 16, 64),
                 routing: Routing | None = None,
                 pipeline: str = "serial",
                 telemetry=None):
        assert pipeline in PIPELINE_MODES, (
            f"unknown pipeline mode {pipeline!r} (one of {PIPELINE_MODES})")
        self.batch_size = batch_size
        self.cost_classes = tuple(sorted(cost_classes))
        self.pipeline = pipeline
        self.stats = PipelineStats()
        # observability (core/telemetry.py): when wired, the scheduler
        # registers its stage meters, records per-request device-latency
        # histograms at dispatch, and drives the sampled lifecycle tracer
        # (submit -> admit -> export_stage -> flip -> dispatch -> resolve).
        # telemetry=None (or disabled) leaves only `is None` branches on
        # the hot path — behaviour is byte-identical to pre-telemetry.
        self.telemetry = (telemetry if telemetry is not None
                          and telemetry.enabled else None)
        self._tracer = (self.telemetry.tracer
                        if self.telemetry is not None else None)
        if self.telemetry is not None:
            self.telemetry.wire_scheduler(self)
            self._lat_hist = {
                "get": self.telemetry.histogram("read_get_latency_seconds",
                                                layer="scheduler"),
                "scan": self.telemetry.histogram("read_scan_latency_seconds",
                                                 layer="scheduler"),
            }
            self._req_hist = self.telemetry.histogram(
                "request_latency_seconds", layer="scheduler")
        else:
            self._lat_hist = None
            self._req_hist = None
        # store-provided wiring (store.routing() — core/api.py): key ->
        # owning shard, the replica read-spreading pick, and the response
        # stamps.  None routes everything to shard 0 and never forwards a
        # replica pin, reproducing the unsharded/unreplicated behaviour.
        self.routing = routing
        self._shard_of = routing.shard_of if routing else (lambda key: 0)
        self._replica_of = routing.replica_of if routing else None
        self._buckets: dict[tuple[int, int, str, int], list[Request]] = \
            defaultdict(list)
        self._writes: list[Request] = []
        self._next_rid = 0
        self.dispatched_batches = 0
        self.dispatched_requests = 0
        self.applied_writes = 0
        self.syncs = 0             # per-shard host->device syncs run() did

    def _cost_class(self, r: Request) -> int:
        for c in self.cost_classes:
            if r.expected_items <= c:
                return c
        return self.cost_classes[-1]

    def _resolve_routing(self, store) -> Routing | None:
        """Routing for the response stamps: the wired one, else ask the
        store (every Honeycomb facade provides ``routing()``; a store
        without one gets unstamped responses)."""
        if self.routing is not None:
            return self.routing
        rt = getattr(store, "routing", None)
        return rt() if callable(rt) else None

    # --------------------------------------------------------- submission
    def submit_op(self, op: Op) -> int:
        """Submit one typed op (core/api.py); returns its sequence number.
        Reads are pinned to (shard, replica) NOW so batches stay shard- and
        replica-homogeneous; writes keep submission order."""
        rid = self._next_rid
        self._next_rid += 1
        r = Request(rid, op, shard=self._shard_of(op.route_key))
        if op.IS_WRITE:
            self._writes.append(r)      # writes keep submission order
        else:
            if self._replica_of is not None:
                r.replica = self._replica_of(r.shard)
            self._buckets[(r.shard, r.replica, op.KIND,
                           self._cost_class(r))].append(r)
        if self._tracer is not None:
            self._tracer.begin(rid, op.KIND, shard=r.shard,
                               replica=r.replica)
        return rid

    def submit(self, kind: str, key: bytes, hi: bytes = b"",
               value: bytes = b"", expected_items: int = 1) -> int:
        """Legacy stringly facade — builds the typed op and delegates to
        ``submit_op`` (ONE execution path; tested op-for-op identical)."""
        cls = OPS_BY_KIND.get(kind)
        assert cls is not None, f"unknown request kind {kind!r}"
        if cls is Scan:
            return self.submit_op(Scan(key, hi, expected_items))
        if cls.IS_WRITE and kind != "delete":
            return self.submit_op(cls(key, value))
        return self.submit_op(cls(key))

    def ready_batches(self, flush: bool = False
                      ) -> Iterable[tuple[str, list[Request]]]:
        """Full read batches (or all remaining when flushing), densest
        first.  Every batch is shard-, replica- and cost-homogeneous.  This
        is THE dispatch order — run() consumes it."""
        for (_, _, kind, _), reqs in sorted(self._buckets.items(),
                                            key=lambda kv: -len(kv[1])):
            while len(reqs) >= self.batch_size or (flush and reqs):
                batch = reqs[: self.batch_size]
                del reqs[: self.batch_size]
                yield kind, batch

    # -------------------------------------------------------------- stages
    def stage_admit(self, store) -> dict[int, Response]:
        """Stage 1 — host-side write phase: every queued write in submission
        order, applied by its op and routed by the store facade, no device
        sync in between (that is the whole point) — each shard's own
        "every_k" policy is deferred for the duration of the burst.  Write
        responses are stamped with the host-tree version at which the
        write became visible."""
        t0 = _now()
        out: dict[int, Response] = {}
        rt = self._resolve_routing(store) if self._writes else None
        tr = self._tracer
        with store.deferred_sync():
            for r in self._writes:
                if tr is not None and tr.is_live(r.rid):
                    a0 = _now()
                    r.op.apply(store)
                    tr.span(r.rid, "admit", a0, _now(), shard=r.shard)
                else:
                    r.op.apply(store)
                out[r.rid] = Response(
                    status=OK, shard=r.shard,
                    serving_version=(rt.live_version(r.shard) if rt else 0))
        self.applied_writes += len(self._writes)
        self._writes.clear()
        self.stats.admit_s += _now() - t0
        return out

    def stage_export(self, store) -> None:
        """Stage 2 — one delta sync per DIRTY shard, covering the whole
        write burst (the paper's batched PCIe synchronization; clean shards
        are untouched).

        Serial mode exports and publishes through the facade's
        ``export_snapshot()`` and then BLOCKS until the device has finished
        the scatters (the sync barrier: reads may not be issued until the
        copy is done); the wait is metered as ``sync_stall_s``.  Pipelined mode
        stages every dirty shard's standby buffer — the scatters are only
        ENQUEUED, and a replicated shard's group hook enqueues one scatter
        per replica lane CONCURRENTLY before any flip — then flips each
        shard independently; read batches dispatch while the scatters
        drain, so the only stall is host staging time."""
        before = store.sync_stats.snapshots
        t0 = _now()
        if self.pipeline == "serial":
            snaps = store.export_snapshot()
            t_mid = _now()
            _block_until_ready(snaps)
        else:
            store.begin_export()
            t_mid = _now()
            store.flip()
        t1 = _now()
        dt = t1 - t0
        self.stats.sync_stall_s += dt   # no reads dispatched yet this epoch
        self.stats.export_s += dt
        self.syncs += store.sync_stats.snapshots - before
        if self._tracer is not None and self._tracer.live_count:
            # the export covers the whole epoch, so attach both stage
            # spans to every in-flight trace.  Serial: export_stage is
            # the staging+publish, flip the wait on the device; pipelined:
            # export_stage stages the standby, flip is the atomic
            # per-shard publish.
            self._tracer.span_all("export_stage", t0, t_mid)
            self._tracer.span_all("flip", t_mid, t1)
        san = _epochsan.get()
        if san is not None:   # stage_export's contract: staged => flipped
            san.check_exported(store)

    def stage_dispatch(self, store, flush: bool = True
                       ) -> dict[int, Response]:
        """Stage 3 — consume ``ready_batches()``: dense, shard- and
        cost-homogeneous device batches, responses reassembled to arrival
        order and stamped from the store's serving report (the replica lane
        that actually answered — a lagging-follower pin redirects to the
        primary — and the read version of its snapshot).  Device-lane
        occupancy is accumulated from the STORE's meters (the shard is
        where ``bucket_pow2`` padding actually happens, including the
        router's per-shard sub-batches and floor back-fill probes), so it
        reflects real device lanes, not the scheduler-level batch sizes."""
        t0 = _now()
        ps = store.pipeline_stats
        lanes0, padded0 = ps.dispatched_lanes, ps.padded_lanes
        rt = self._resolve_routing(store)
        out: dict[int, Response] = {}
        tm, tr = self.telemetry, self._tracer
        for kind, batch in self.ready_batches(flush=flush):
            self.dispatched_batches += 1
            self.dispatched_requests += len(batch)
            shard = batch[0].shard
            # batches are replica-homogeneous; forward the pin only when a
            # read-spreading policy is wired (plain stores take no replica)
            kw = ({"replica": batch[0].replica}
                  if self._replica_of is not None else {})
            b0 = _now() if tm is not None else 0.0
            if kind == "get":
                res = store.get_batch([r.key for r in batch], **kw)
            else:
                res = store.scan_batch([(r.key, r.hi) for r in batch], **kw)
            served, rv = (rt.report(shard) if rt is not None
                          else (batch[0].replica, 0))
            if tm is not None:
                b1 = _now()
                # spread the batch's device time over its requests: one
                # weighted record per batch keeps the histogram O(1)
                self._lat_hist[kind].record((b1 - b0) / len(batch),
                                            n=len(batch))
                if tr is not None and tr.live_count:
                    for r in batch:
                        if tr.is_live(r.rid):
                            tr.span(r.rid, "dispatch", b0, b1, shard=shard,
                                    replica=served, serving_version=rv)
            for r, v in zip(batch, res):
                if kind == "get":
                    out[r.rid] = Response(
                        status=OK if v is not None else NOT_FOUND,
                        value=v, serving_version=rv, shard=shard,
                        replica=served)
                else:
                    out[r.rid] = Response(
                        status=OK, items=v, serving_version=rv,
                        shard=shard, replica=served)
        ps = store.pipeline_stats
        self.stats.dispatched_lanes += ps.dispatched_lanes - lanes0
        self.stats.padded_lanes += ps.padded_lanes - padded0
        self.stats.dispatch_s += _now() - t0
        return out

    # ---------------------------------------------------------- the epoch
    def run_ops(self, store, flush: bool = True) -> dict[int, Response]:
        """Drive all pending ops through the store: one full pipeline epoch
        — admit writes (in order), sync each dirty shard, dispatch the
        batched read paths.  Returns {rid: Response} with in-order
        semantics per sequence number."""
        out = self.stage_admit(store)
        if out:
            self.stage_export(store)
        out.update(self.stage_dispatch(store, flush=flush))
        self.stats.runs += 1
        if self._tracer is not None and self._tracer.live_count:
            self._finish_traces(store, out)
        return out

    def _finish_traces(self, store,
                       out: dict[int, Response]) -> None:
        """Resolve every live trace whose response landed this epoch:
        stamp it with the response's (shard, replica, serving_version)
        plus the serving shard's snapshot epoch, append the resolve
        instant, and record the submit->resolve request latency."""
        tr = self._tracer
        epochs = getattr(store, "per_shard_epochs", None)
        for rid in tr.live_rids():
            resp = out.get(rid)
            if resp is None:
                continue        # not resolved this epoch (flush=False)
            epoch = (epochs[resp.shard] if epochs is not None
                     else getattr(store, "epoch", 0))
            t = tr.finish(rid, shard=resp.shard, replica=resp.replica,
                          serving_version=resp.serving_version,
                          epoch=epoch, status=resp.status)
            if t is not None:
                self._req_hist.record(max(t.t1 - t.t0, 0.0))

    def run(self, store, flush: bool = True) -> dict[int, Any]:
        """Shim over ``run_ops``: same epoch, responses unwrapped to bare
        values ({rid: value | items | None})."""
        return {rid: resp.unwrap()
                for rid, resp in self.run_ops(store, flush=flush).items()}
