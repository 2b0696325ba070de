"""Op wire accounting (port of part of ``repro.core.api``).

One log entry on the wire is ``op byte + u16 keylen + u16 vallen`` followed
by the key and value bytes.  ``SyncStats.log_wire_bytes`` meters every
write with this exact size.  The op messages, the codec and the service
front end come with the service layer.
"""
from __future__ import annotations

# op byte + u16 key length + u16 value length
WIRE_ENTRY_OVERHEAD = 5


def wire_entry_nbytes(key: bytes, value: bytes = b"") -> int:
    """Exact wire size of one log entry — the accounting the reference's
    encoder and ``SyncStats.log_wire_bytes`` share."""
    return WIRE_ENTRY_OVERHEAD + len(key) + len(value)
