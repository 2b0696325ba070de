"""Packed node-image layout: the ONE schema for per-node snapshot fields
(port of ``repro.core.schema``).

The host heap stays structure-of-arrays (columnar writes, 64-bit MVCC
authority); what crosses the host->device bus, and what the device keeps
resident, is ONE packed ``(node_cap, image_words)`` image: every per-node
field maps to a static ``(word_offset, width)`` column slice of its node's
image row.  A dirty node then syncs as a single contiguous row copy.

Layout contract (held equal to the reference's pinned golden by
tests/test_torch_foundations.py):
  * fields are laid out in ``NODE_SCHEMA`` order, no padding, 4-byte words;
  * every device field is exactly one 32-bit word per element.  Wider host
    types (the 64-bit version counters, the byte-wide log op/hint codes)
    narrow to int32 on the way in;
  * signed fields cross as their int32 bit pattern (NULL = -1 survives).

On the device the image is a ``torch.int32`` tensor holding the bit
pattern of each u32 word: PyTorch's ``uint32`` has no comparison or gather
kernels on the CPU, so unsigned key and value lanes ride as their int32
bit views and every field decodes with a plain column slice.

With the paper's geometry (64-cap nodes, 16 log entries, 8 shortcuts,
32 B keys / 16 B inline values) the image row is 1273 words = 5092 B.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np

from .config import HoneycombConfig
from .keys import pack_key

_NULL = -1   # matches heap.NULL: "no slot / no sibling / no old version"


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One per-node field: its host storage and its device representation.

    ``dims`` name the per-node trailing shape via ``HoneycombConfig``
    attributes (the leading node-capacity dim is implicit).  ``host``
    is the heap's numpy dtype; ``device`` (uint32/int32 only — one image
    word per element) is what crosses the bus and lives in the image.
    """
    name: str
    dims: tuple[str, ...] = ()
    host: str = "int32"
    device: str = "int32"
    fill: int = 0

    def shape(self, cfg: HoneycombConfig) -> tuple[int, ...]:
        return tuple(getattr(cfg, d) for d in self.dims)

    @property
    def narrowed(self) -> bool:
        """True when the device image narrows the host dtype."""
        return self.host != self.device


# THE per-node field list, in image/layout order.
NODE_SCHEMA: tuple[FieldSpec, ...] = (
    FieldSpec("ntype"),
    FieldSpec("nitems"),
    FieldSpec("version", host="int64"),
    FieldSpec("oldptr", fill=_NULL),      # previous-version phys slot
    FieldSpec("left_child", fill=_NULL),  # interior: leftmost child LID
    FieldSpec("lsib", fill=_NULL),        # leaf: sibling LIDs
    FieldSpec("rsib", fill=_NULL),
    FieldSpec("skeys", ("node_cap", "key_words"), "uint32", "uint32"),
    FieldSpec("skeylen", ("node_cap",)),
    FieldSpec("svals", ("node_cap", "val_words"), "uint32", "uint32"),
    FieldSpec("svallen", ("node_cap",)),
    FieldSpec("n_shortcuts"),
    FieldSpec("sc_keys", ("n_shortcuts", "key_words"), "uint32", "uint32"),
    FieldSpec("sc_keylen", ("n_shortcuts",)),
    FieldSpec("sc_pos", ("n_shortcuts",)),
    FieldSpec("nlog"),
    FieldSpec("log_keys", ("log_cap", "key_words"), "uint32", "uint32"),
    FieldSpec("log_keylen", ("log_cap",)),
    FieldSpec("log_vals", ("log_cap", "val_words"), "uint32", "uint32"),
    FieldSpec("log_vallen", ("log_cap",)),
    FieldSpec("log_op", ("log_cap",), host="int8"),
    FieldSpec("log_backptr", ("log_cap",)),
    FieldSpec("log_hint", ("log_cap",), host="uint8"),
    FieldSpec("log_vdelta", ("log_cap",), host="int64"),
)

FIELD_NAMES: tuple[str, ...] = tuple(f.name for f in NODE_SCHEMA)

# fields the device image narrows to int32 (host keeps 64-bit authority)
NARROWED_FIELDS: frozenset[str] = frozenset(
    f.name for f in NODE_SCHEMA if f.narrowed)


@dataclasses.dataclass(frozen=True)
class FieldSlot:
    """Resolved placement of one field inside the image row."""
    spec: FieldSpec
    offset: int                 # first 32-bit word of the field's slice
    words: int                  # words per node
    shape: tuple[int, ...]      # per-node trailing shape


class NodeImageLayout:
    """Field -> (word_offset, width) map of the packed node image for one
    config, plus host pack / device view / host unpack helpers."""

    def __init__(self, cfg: HoneycombConfig):
        self.cfg = cfg
        slots: dict[str, FieldSlot] = {}
        off = 0
        for spec in NODE_SCHEMA:
            shape = spec.shape(cfg)
            words = int(np.prod(shape, dtype=np.int64)) if shape else 1
            slots[spec.name] = FieldSlot(spec, off, words, shape)
            off += words
        self.slots = slots
        self.image_words = off          # words per node image row

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def for_config(cfg: HoneycombConfig) -> "NodeImageLayout":
        return NodeImageLayout(cfg)

    @property
    def node_image_bytes(self) -> int:
        """Bytes of one node's contiguous image row (the copy unit)."""
        return self.image_words * 4

    def offsets(self) -> dict[str, tuple[int, int]]:
        """{field: (word_offset, words)}."""
        return {n: (s.offset, s.words) for n, s in self.slots.items()}

    # ---------------------------------------------------------- host side
    def pack(self, heap, rows: np.ndarray | None = None) -> np.ndarray:
        """Marshal heap rows into contiguous node images: [D, image_words]
        u32 (D = all rows when ``rows`` is None).  Narrows wide host dtypes
        to int32 and bit-preserves signedness; the result is a fresh
        buffer, so later host mutations can never reach a staged
        snapshot."""
        n = heap.capacity if rows is None else len(rows)
        img = np.empty((n, self.image_words), np.uint32)
        for name, slot in self.slots.items():
            arr = getattr(heap, name)
            arr = arr if rows is None else arr[rows]
            dev = np.ascontiguousarray(arr.astype(slot.spec.device,
                                                  copy=False))
            img[:, slot.offset:slot.offset + slot.words] = \
                dev.view(np.uint32).reshape(n, slot.words)
        return img

    def unpack(self, img: np.ndarray) -> dict[str, np.ndarray]:
        """Host-side inverse of ``pack`` (tests / debugging): image rows
        back to per-field arrays in their DEVICE dtypes."""
        out = {}
        for name, slot in self.slots.items():
            col = np.ascontiguousarray(
                img[:, slot.offset:slot.offset + slot.words])
            out[name] = col.view(np.dtype(slot.spec.device)) \
                .reshape((len(img), *slot.shape))
        return out

    # -------------------------------------------------------- device side
    def view(self, image, name: str):
        """Decode one field from an int32 device image: a static column
        slice reshaped to the field's per-node shape.  Signed fields read
        as themselves; unsigned lanes stay int32 bit views."""
        slot = self.slots[name]
        col = image[:, slot.offset:slot.offset + slot.words]
        return col.reshape((image.shape[0], *slot.shape))

    def field_views(self, image) -> dict[str, object]:
        """All field views of a device image (snapshot adapter)."""
        return {name: self.view(image, name) for name in self.slots}

    # -------------------------------------------- log-replay addressing
    # One decoded wire op + its placement sidecar marshal into a dense
    # log_entry_words-u32 record; the log_replay_scatter kernel
    # (kernels/csrc/log_replay.cu) scatters each record into its node's
    # image row at these static offsets + slot * field width — the
    # entry->row address map of the log-shipped replication feed.

    @property
    def log_entry_words(self) -> int:
        """u32 words per marshalled log entry: key lanes + keylen + value
        lanes + vallen + op + backptr + hint + vdelta."""
        return self.cfg.key_words + self.cfg.val_words + 6

    def log_replay_offsets(self) -> "LogReplayOffsets":
        """Static image-row word offsets the replay kernel scatters to (a
        hashable tuple of ints, equal to the reference's)."""
        s = self.slots
        return LogReplayOffsets(
            key_words=self.cfg.key_words,
            val_words=self.cfg.val_words,
            nlog=s["nlog"].offset,
            log_keys=s["log_keys"].offset,
            log_keylen=s["log_keylen"].offset,
            log_vals=s["log_vals"].offset,
            log_vallen=s["log_vallen"].offset,
            log_op=s["log_op"].offset,
            log_backptr=s["log_backptr"].offset,
            log_hint=s["log_hint"].offset,
            log_vdelta=s["log_vdelta"].offset)

    def pack_log_entries(self, ops, op_codes, backptrs, hints,
                         vdeltas) -> np.ndarray:
        """Marshal decoded wire ops + placement sidecar into the dense
        ``[E, log_entry_words]`` u32 block the replay kernel consumes.

        Key and inline-value lanes are packed exactly like the host write
        path (big-endian u32 lanes, zero padded; ``core/keys.pack_key`` /
        ``HoneycombTree._store_value``), and the narrow int sidecar fields
        cross as their int32 bit pattern — the same narrowing ``pack()``
        applies — so a replayed row is bit-identical to the primary's
        packed row.  Values longer than the inline budget never reach
        here: such epochs are not replayable (core/shard.py falls back to
        the image delta)."""
        cfg = self.cfg
        kw, vw = cfg.key_words, cfg.val_words
        blk = np.zeros((len(ops), self.log_entry_words), np.uint32)
        for i, op in enumerate(ops):
            key = op.key
            val = getattr(op, "value", b"")
            assert len(val) <= cfg.max_inline_val_bytes, (
                "overflow-length value in a log-replay payload")
            blk[i, 0:kw] = pack_key(key, kw)
            blk[i, kw] = len(key)
            if val:
                buf = val + b"\x00" * (-len(val) % 4)
                lanes = np.frombuffer(buf, dtype=">u4")
                blk[i, kw + 1:kw + 1 + len(lanes)] = lanes
            blk[i, kw + 1 + vw] = len(val)
        blk[:, kw + vw + 2] = np.asarray(op_codes, np.int64) \
            .astype(np.int32).view(np.uint32)
        blk[:, kw + vw + 3] = np.asarray(backptrs, np.int64) \
            .astype(np.int32).view(np.uint32)
        blk[:, kw + vw + 4] = np.asarray(hints, np.int64) \
            .astype(np.int32).view(np.uint32)
        blk[:, kw + vw + 5] = np.asarray(vdeltas, np.int64) \
            .astype(np.int32).view(np.uint32)
        return blk


class LogReplayOffsets(NamedTuple):
    """Static layout constants of one log-replay scatter (all ints, so the
    tuple is hashable).  ``log_*``/``nlog`` are image-row word offsets;
    per-slot fields advance by their width per log slot."""
    key_words: int
    val_words: int
    nlog: int
    log_keys: int
    log_keylen: int
    log_vals: int
    log_vallen: int
    log_op: int
    log_backptr: int
    log_hint: int
    log_vdelta: int

    @property
    def log_cap(self) -> int:
        """Log slots per node: the ``log_keys`` field holds ``log_cap``
        keys of ``key_words`` lanes and ends where ``log_keylen`` begins."""
        return (self.log_keylen - self.log_keys) // self.key_words
