"""Op wire messages and their codec (port of part of ``repro.core.api``).

One log entry on the wire is ``op byte + u16 keylen + u16 vallen``
followed by the key and value bytes; SCAN carries its upper bound in the
value slot and appends a u16 expected-items hint.  The frozen op
dataclasses ``Get`` / ``Scan`` / ``Put`` / ``Update`` / ``Delete`` each
encode themselves (``encode_wire``); ``decode_wire`` /
``decode_wire_stream`` invert it.  ``SyncStats.log_wire_bytes`` meters
every write with ``wire_entry_nbytes``, the encoder's exact size, and the
log-shipped replication feed (core/replica.py) ships each epoch's writes
as one such stream.  ``Response``, ``Ticket``, ``Routing`` and the
service front end come with the service layer.
"""
from __future__ import annotations

import dataclasses
import struct

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
