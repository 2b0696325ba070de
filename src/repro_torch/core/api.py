"""Typed request/response service API (port of ``repro.core.api``).

One log entry on the wire is ``op byte + u16 keylen + u16 vallen``
followed by the key and value bytes; SCAN carries its upper bound in the
value slot and appends a u16 expected-items hint.  The frozen op
dataclasses ``Get`` / ``Scan`` / ``Put`` / ``Update`` / ``Delete`` each
encode themselves (``encode_wire``); ``decode_wire`` /
``decode_wire_stream`` invert it.  ``SyncStats.log_wire_bytes`` meters
every write with ``wire_entry_nbytes``, the encoder's exact size, and the
log-shipped replication feed (core/replica.py) ships each epoch's writes
as one such stream.

The service front end over them:

  * **Response** — every completed op resolves to
    ``Response(status, value|items, serving_version, shard, replica)``.
    Reads are stamped with the read version of the snapshot that answered
    and the replica lane that served; writes with the host-tree version at
    which they became visible.
  * **Ticket** — what ``HoneycombService.submit`` returns: ``.result()``
    drains the service's pipeline epoch if the response is not in yet.
  * **Routing** — the store-provided wiring the scheduler consumes
    (``routing()`` of ``HoneycombStore``, ``ShardedHoneycombStore`` and
    ``ReplicaGroup``): key -> shard, the replica read-spreading pick, the
    per-dispatch serving report and the live host version.
  * **HoneycombService** — wraps ANY facade, self-wires routing from the
    store, and drives the out-of-order scheduler (core/scheduler.py):
    ``submit(op) -> Ticket``, ``submit_many(ops)``, ``drain()`` runs one
    pipeline epoch and resolves every pending ticket.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Iterable

# op byte + u16 key length + u16 value length
WIRE_ENTRY_OVERHEAD = 5
_WIRE_HEADER = struct.Struct(">BHH")
_WIRE_U16 = struct.Struct(">H")


def wire_entry_nbytes(key: bytes, value: bytes = b"") -> int:
    """Exact wire size of one log entry — THE shared accounting between the
    op encoder below and the store's ``SyncStats.log_wire_bytes`` meter
    (core/shard.py), so the meter and the encoder can never drift."""
    return WIRE_ENTRY_OVERHEAD + len(key) + len(value)


class WireDecodeError(ValueError):
    """A wire buffer failed to decode: truncated header or payload, or an
    unknown op code.  Decoding is all-or-nothing — a stream that raises
    has applied NOTHING, so a replication feed can fall back to a full
    resync instead of replaying a silently partial epoch."""


def _encode(code: int, a: bytes, b: bytes = b"", tail: bytes = b"") -> bytes:
    assert len(a) <= 0xFFFF and len(b) <= 0xFFFF, (
        f"wire entry field over the u16 length limit "
        f"({len(a)}/{len(b)} bytes)")
    return _WIRE_HEADER.pack(code, len(a), len(b)) + a + b + tail


# ----------------------------------------------------------------------- ops
@dataclasses.dataclass(frozen=True)
class Get:
    """Point lookup: resolves to the value at ``key`` (or not_found)."""
    key: bytes

    KIND = "get"
    IS_WRITE = False
    OP_CODE = 1

    @property
    def route_key(self) -> bytes:
        return self.key

    @property
    def expected_items(self) -> int:
        return 1

    def encode_wire(self) -> bytes:
        return _encode(self.OP_CODE, self.key)


@dataclasses.dataclass(frozen=True)
class Scan:
    """Ordered range read over ``[lo, hi]`` (floor-start semantics, paper
    Section 3.3); ``expected_items`` is the cost hint the scheduler buckets
    by."""
    lo: bytes
    hi: bytes
    expected_items: int = 1

    KIND = "scan"
    IS_WRITE = False
    OP_CODE = 2

    @property
    def route_key(self) -> bytes:
        return self.lo   # the owning shard of the range start; the store
        # facade decomposes any cross-shard tail

    def encode_wire(self) -> bytes:
        assert 0 <= self.expected_items <= 0xFFFF, (
            f"expected_items {self.expected_items} over the u16 limit")
        return _encode(self.OP_CODE, self.lo, self.hi,
                       _WIRE_U16.pack(self.expected_items))


@dataclasses.dataclass(frozen=True)
class Put:
    """Blind insert/overwrite of ``key`` with ``value``."""
    key: bytes
    value: bytes

    KIND = "put"
    IS_WRITE = True
    OP_CODE = 3

    @property
    def route_key(self) -> bytes:
        return self.key

    @property
    def expected_items(self) -> int:
        return 1

    def encode_wire(self) -> bytes:
        return _encode(self.OP_CODE, self.key, self.value)

    def apply(self, store) -> None:
        store.put(self.key, self.value)


@dataclasses.dataclass(frozen=True)
class Update:
    """In-place update of an existing ``key``."""
    key: bytes
    value: bytes

    KIND = "update"
    IS_WRITE = True
    OP_CODE = 4

    @property
    def route_key(self) -> bytes:
        return self.key

    @property
    def expected_items(self) -> int:
        return 1

    def encode_wire(self) -> bytes:
        return _encode(self.OP_CODE, self.key, self.value)

    def apply(self, store) -> None:
        store.update(self.key, self.value)


@dataclasses.dataclass(frozen=True)
class Delete:
    """Tombstone ``key``."""
    key: bytes

    KIND = "delete"
    IS_WRITE = True
    OP_CODE = 5

    @property
    def route_key(self) -> bytes:
        return self.key

    @property
    def expected_items(self) -> int:
        return 1

    def encode_wire(self) -> bytes:
        return _encode(self.OP_CODE, self.key)

    def apply(self, store) -> None:
        store.delete(self.key)


Op = Get | Scan | Put | Update | Delete
OPS_BY_CODE: dict[int, type] = {c.OP_CODE: c
                                for c in (Get, Scan, Put, Update, Delete)}
OPS_BY_KIND: dict[str, type] = {c.KIND: c
                                for c in (Get, Scan, Put, Update, Delete)}
WRITE_KINDS = tuple(k for k, c in OPS_BY_KIND.items() if c.IS_WRITE)


def decode_wire(data: bytes, offset: int = 0) -> tuple[Op, int]:
    """Decode one op from ``data`` at ``offset``; returns (op, next_offset)
    so a log-structured stream of entries decodes by chaining offsets.
    Raises :class:`WireDecodeError` on a truncated or garbage buffer."""
    if offset + WIRE_ENTRY_OVERHEAD > len(data):
        raise WireDecodeError(
            f"truncated wire header at offset {offset}: need "
            f"{WIRE_ENTRY_OVERHEAD} bytes, {len(data) - offset} remain")
    code, alen, blen = _WIRE_HEADER.unpack_from(data, offset)
    cls = OPS_BY_CODE.get(code)
    if cls is None:
        raise WireDecodeError(
            f"unknown wire op code {code} at offset {offset}")
    p = offset + WIRE_ENTRY_OVERHEAD
    if p + alen + blen > len(data):
        raise WireDecodeError(
            f"truncated wire entry at offset {offset}: header promises "
            f"{alen}+{blen} payload bytes, {len(data) - p} remain")
    a, b = bytes(data[p: p + alen]), bytes(data[p + alen: p + alen + blen])
    p += alen + blen
    if cls is Get:
        return Get(a), p
    if cls is Scan:
        if p + _WIRE_U16.size > len(data):
            raise WireDecodeError(
                f"truncated SCAN entry at offset {offset}: the u16 "
                f"expected-items tail is missing")
        (expected,) = _WIRE_U16.unpack_from(data, p)
        return Scan(a, b, expected), p + _WIRE_U16.size
    if cls is Delete:
        return Delete(a), p
    return cls(a, b), p


def decode_wire_stream(data: bytes) -> list[Op]:
    """Decode a whole append-only entry stream (the replica log-replay feed
    shape: deltas as a byte stream of ops instead of node rows)."""
    ops, offset = [], 0
    while offset < len(data):
        op, offset = decode_wire(data, offset)
        ops.append(op)
    return ops


# ----------------------------------------------------------------- responses
OK = "ok"
NOT_FOUND = "not_found"


@dataclasses.dataclass(frozen=True)
class Response:
    """One completed op, reassembled in arrival order and stamped for
    linearizability checks.

    ``serving_version`` is the read version of the snapshot a read answered
    from (the host-tree version at which a write became visible, for
    writes); ``shard`` is the owning range-shard and ``replica`` the lane
    that actually served (0 = primary — also when a lagging follower pin
    was redirected by the freshness rule)."""
    status: str
    value: bytes | None = None        # GET result
    items: list | None = None         # SCAN result (key, value) pairs
    serving_version: int = 0
    shard: int = 0
    replica: int = 0

    @property
    def ok(self) -> bool:
        return self.status == OK

    def unwrap(self):
        """The bare result: SCAN items, GET value (None when not_found),
        None for writes — what ``OutOfOrderScheduler.run()`` returns."""
        return self.items if self.items is not None else self.value


class Ticket:
    """Future for one submitted op: resolved by the service's next
    ``drain()`` (``result()`` drains on demand)."""
    __slots__ = ("rid", "op", "_service", "_response")

    def __init__(self, rid: int, op: Op, service: "HoneycombService"):
        self.rid = rid
        self.op = op
        self._service = service
        self._response: Response | None = None

    @property
    def done(self) -> bool:
        return self._response is not None

    def result(self) -> Response:
        if self._response is None:
            self._service.drain()       # one pipeline epoch resolves us
        if self._response is None:
            raise RuntimeError(f"drain() did not resolve ticket {self.rid}")
        return self._response

    def _resolve(self, response: Response) -> None:
        self._response = response

    def __repr__(self) -> str:
        state = self._response if self.done else "pending"
        return f"Ticket(rid={self.rid}, op={self.op!r}, {state})"


# ------------------------------------------------------------------- routing
@dataclasses.dataclass(frozen=True)
class Routing:
    """Store-provided request wiring — what ``store.routing()`` returns and
    the scheduler consumes.

    ``shard_of`` maps a route key to its owning shard; ``replica_of`` is
    the read-spreading pick (None when the store takes no replica pin — the
    unreplicated facade); ``report`` returns, for a shard that just served
    a device batch, ``(replica_served, serving_version)`` — the stamp for
    read responses; ``live_version`` returns the shard's current host-tree
    read version — the stamp for write responses."""
    shard_of: Callable[[bytes], int]
    replica_of: Callable[[int], int] | None
    report: Callable[[int], tuple[int, int]]
    live_version: Callable[[int], int]


# ------------------------------------------------------------------- service
class HoneycombService:
    """The typed serving front end: wraps ANY store facade (plain
    ``HoneycombStore``, ``ShardedHoneycombStore``, bare ``ReplicaGroup``),
    self-wires routing from ``store.routing()``, and drives the
    out-of-order scheduler's admit/export/dispatch pipeline.

    ``submit(op)`` returns a ``Ticket``; ``drain()`` runs ONE pipeline
    epoch (writes admitted in order, one delta sync per dirty shard, dense
    replica-pinned read batches) and resolves every pending ticket with a
    stamped ``Response``."""

    def __init__(self, store, cfg: "ServiceConfig | None" = None, **over):
        from .config import ServiceConfig
        from .scheduler import OutOfOrderScheduler
        from .telemetry import Telemetry
        self.cfg = dataclasses.replace(cfg or ServiceConfig(), **over)
        self.store = store
        self.routing: Routing = store.routing()
        # observability (core/telemetry.py): one registry per service,
        # every stats surface the store facade exposes registered as a
        # live collect() source, the scheduler wired for latency
        # histograms + sampled lifecycle traces.  Disabled => None and
        # nothing is constructed.
        tcfg = self.cfg.telemetry
        self.telemetry = (Telemetry(tcfg).wire_store(store)
                          if tcfg.enabled else None)
        self.scheduler = OutOfOrderScheduler(
            batch_size=self.cfg.batch_size,
            cost_classes=self.cfg.cost_classes,
            routing=self.routing, pipeline=self.cfg.pipeline,
            telemetry=self.telemetry)
        self._pending: dict[int, Ticket] = {}

    # ---------------------------------------------------------- submission
    def submit(self, op: Op) -> Ticket:
        rid = self.scheduler.submit_op(op)
        ticket = Ticket(rid, op, self)
        self._pending[rid] = ticket
        return ticket

    def submit_many(self, ops: Iterable[Op]) -> list[Ticket]:
        return [self.submit(op) for op in ops]

    def drain(self, flush: bool = True) -> dict[int, Response]:
        """Run one pipeline epoch over everything submitted so far and
        resolve the pending tickets; returns {rid: Response}."""
        out = self.scheduler.run_ops(self.store, flush=flush)
        for rid, response in out.items():
            ticket = self._pending.pop(rid, None)
            if ticket is not None:
                ticket._resolve(response)
        return out

    # ------------------------------------------------------------- meters
    @property
    def stats(self):
        """The scheduler's per-stage pipeline meters."""
        return self.scheduler.stats

    # -------------------------------------------------------- telemetry
    #   (all None-safe: a disabled service answers with empty exports)
    def metrics_snapshot(self) -> dict:
        """Flat JSON-able registry snapshot (core/telemetry.py)."""
        return self.telemetry.snapshot() if self.telemetry else {}

    def prometheus(self) -> str:
        """Prometheus text exposition of the registry."""
        return self.telemetry.to_prometheus() if self.telemetry else ""

    def traces(self):
        """Finished sampled lifecycle traces (oldest first)."""
        return self.telemetry.traces() if self.telemetry else []

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON of the sampled traces (Perfetto)."""
        return (self.telemetry.chrome_trace() if self.telemetry
                else {"traceEvents": []})

    @property
    def syncs(self) -> int:
        return self.scheduler.syncs

    @property
    def pending(self) -> int:
        return len(self._pending)
