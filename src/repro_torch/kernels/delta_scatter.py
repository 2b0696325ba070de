"""Snapshot scatters on the GPU (port of
``repro.kernels.delta_scatter``: ``snapshot_delta_scatter`` /
``snapshot_image_scatter``, ``snapshot_multi_scatter`` and
``log_replay_scatter``).

Delta sync: one sync's dirty node rows arrive as a dense [D, W] update
block plus a [D] row-index vector; the kernel (``csrc/row_scatter.cu``)
copies each update row over the matching row of the resident [S, W] image
in place.  This is the device half of the PCIe analogue: the host ships
O(dirty) bytes and the device image is patched, never rebuilt.  Repeated
rows must carry identical data, which keeps the scatter order-free.

Legacy layout: the snapshot keeps one tensor per node field, so a delta
ships 24 [D, W_f] blocks; ``csrc/multi_scatter.cu`` scatters the dirty
rows of every field in one launch, the field table passed by value.

Both kernels run one copy over the flattened row, the fields
concatenated in schema order (``csrc/scatter_rows.cuh``);
``scatter_plan`` sizes its blocks, and ``ref.flat_scatter_mirror`` walks
the same assignment on the CPU.

Log replay: a follower replica applies one epoch's marshalled wire
entries to its own image (``csrc/log_replay.cu``): each entry moves only
its ~(key_words + val_words + 6) words into its leaf's log slot, instead
of a whole image row per dirty node.  A block takes ``replay_plan``'s
entries and reads every (row, slot) pair once; the kernel also makes the
range check and writes its verdict to a flag, which the wrapper reads
back once after the launch (``ref.replay_verdict`` mirrors it).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import torch

from . import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # dst, S, W, rows, upd, D, threads, K, stream
    "row_scatter": [_P, _I, _I, _P, _P, _I, _I, _I, _P],
    # dst pointers, upd pointers, widths, nf, S, rows, D, threads, K, stream
    "multi_scatter": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P],
    # image, S, IW, rows, slots, entries, D, EW, log_cap, E, threads, flag,
    # 11 layout offsets, stream
    "log_replay": [_P, _I, _I, _P, _P, _P] + [_I] * 5 + [_P] + [_I] * 11
    + [_P],
}


def _launcher(name: str):
    return build.launcher(name, f"{name}_launch", _ARGTYPES[name])


#: fields one multi-scatter launch takes (csrc/scatter_rows.cuh kMaxFields)
MAX_FIELDS = 32
#: threads a block of the row copy may have (scatter_rows.cuh kMaxThreads):
#: 8 blocks of up to 256 fill a streaming multiprocessor's 2,048 threads
MAX_THREADS = 256
#: the words a thread loads before it stores, one kernel instance each:
#: what the stores' rows need (345, 921 and 1,273 words take 2, 4 and 8)
K_CHOICES = (2, 4, 8)
#: the register budget of a thread's loaded words
REG_BYTES = 4 * K_CHOICES[-1]


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """How the row copy of ``csrc/scatter_rows.cuh`` covers D dirty rows
    of flattened width W = ``offsets[-1]``: ``grid`` = D blocks of
    ``threads`` threads, one row a block, its W words in ``chunks`` chunks
    of ``k * threads``; in a chunk, thread t loads words
    ``k' * threads + t`` for every k' < k, then stores them."""
    offsets: tuple
    threads: int
    k: int
    grid: int
    chunks: int
    reg_bytes: int = REG_BYTES


@functools.lru_cache(maxsize=64)
def scatter_plan(widths: tuple, D: int) -> ScatterPlan:
    """The row copy's plan for fields of these widths (in 32-bit words,
    schema order) and D dirty rows.  K is the smallest choice that covers
    a row with at most ``MAX_THREADS`` threads (a row wider than 8 * 256
    words takes several chunks); threads are a whole number of warps.  At
    the default geometry (W = 1273): K = 8, 160 threads."""
    widths = tuple(int(w) for w in widths)
    if not 1 <= len(widths) <= MAX_FIELDS or min(widths) < 0:
        raise ValueError(f"need 1 to {MAX_FIELDS} fields of width >= 0, "
                         f"got {widths}")
    if D < 0:
        raise ValueError(f"D must be >= 0, got {D}")
    offsets = tuple(itertools.accumulate(widths, initial=0))
    W = offsets[-1]
    if W < 1:
        raise ValueError("the fields hold no word")
    k = next((k for k in K_CHOICES if -(-W // k) <= MAX_THREADS),
             K_CHOICES[-1])
    threads = min(MAX_THREADS, 32 * -(-W // (32 * k)))
    return ScatterPlan(offsets, threads, k, D, -(-W // (k * threads)))


#: entries one block of the log replay takes (csrc/log_replay.cu kEntries)
ENTRIES_PER_BLOCK = 8
#: the (row, slot) pairs a thread of the log replay loads before it compares
#: any (log_replay.cu kPairsPerThread)
REPLAY_PAIRS_PER_THREAD = 4
#: threads a block of the log replay may have (log_replay.cu kMaxThreads)
REPLAY_MAX_THREADS = 512
#: shared memory a block may take without opt-in (log_replay.cu
#: kMaxSmemBytes)
REPLAY_SMEM_BYTES = 48 * 1024


@dataclasses.dataclass(frozen=True)
class ReplayPlan:
    """How the log replay (``csrc/log_replay.cu``) covers D entries of EW
    words: ``grid`` blocks of ``threads`` threads, block b taking entries
    [b * entries, min((b + 1) * entries, D)).  Where ``held`` (D at most
    ``ENTRIES_PER_BLOCK``) every block holds all D pairs in registers and
    takes one entry; else every block walks all D pairs in ``chunks``
    chunks of ``pair_chunk`` = ``k * threads``, thread t taking pairs
    ``c * pair_chunk + k' * threads + t`` for k' < k.  ``smem_bytes`` is
    a block's shared memory: its records and each warp's maxima for its
    entries."""
    D: int
    held: bool
    entries: int
    threads: int
    grid: int
    k: int
    pair_chunk: int
    chunks: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def replay_plan(D: int, EW: int) -> ReplayPlan:
    """The log replay's plan for D entries of EW words: one entry a block
    while D fits a thread's registers (the record stores of different
    entries then issue from different SMs), else ``ENTRIES_PER_BLOCK`` a
    block (the last may hold fewer); threads enough for
    ``REPLAY_PAIRS_PER_THREAD`` pairs each and for one word each of a
    block's records (a thread's stores issue one after another, each
    waiting on its address), whole warps, from 32 to
    ``REPLAY_MAX_THREADS``.  At the default geometry (EW = 18): D = 4
    takes 4 blocks of 32 threads, D = 1,024 128 blocks of 256.  Raises
    ValueError for records too wide for the block's shared memory."""
    if D < 1 or EW < 1:
        raise ValueError(f"need D >= 1 and EW >= 1, got {D} and {EW}")
    K, held = REPLAY_PAIRS_PER_THREAD, D <= ENTRIES_PER_BLOCK
    E = 1 if held else ENTRIES_PER_BLOCK
    need = max(-(-D // K), E * EW)
    threads = min(REPLAY_MAX_THREADS, max(32, 32 * -(-need // 32)))
    smem = 4 * ENTRIES_PER_BLOCK * (EW + threads // 32)
    if smem > REPLAY_SMEM_BYTES:
        raise ValueError(f"log records of {EW} words do not fit the replay "
                         f"kernel's shared memory")
    return ReplayPlan(D, held, E, threads, -(-D // E), K, K * threads,
                      -(-D // (K * threads)), smem)


def snapshot_delta_scatter(dst: torch.Tensor, rows: torch.Tensor,
                           upd: torch.Tensor) -> torch.Tensor:
    """dst[rows[i], :] = upd[i, :] for i in range(D), in place on CUDA.

    dst:  [S, W] resident device array of any 4-byte dtype
    rows: [D] int32 target rows (repeats allowed with identical data)
    upd:  [D, W] replacement rows, same dtype as ``dst``
    Returns ``dst``."""
    build.check_tensor(dst, "dst", 2)
    build.check_tensor(rows, "rows", 1, dst.device)
    build.check_tensor(upd, "upd", 2, dst.device)
    if rows.dtype != torch.int32 or upd.dtype != dst.dtype:
        raise ValueError("rows must be int32 and upd must match dst's dtype")
    if dst.element_size() != 4:
        raise ValueError(f"the scatter moves 4-byte words, got {dst.dtype}")
    S, W = dst.shape
    D = rows.shape[0]
    if upd.shape != (D, W):
        raise ValueError(f"upd must be [{D}, {W}], got {tuple(upd.shape)}")
    if D == 0 or W == 0:
        return dst
    ref.check_rows(rows, S)        # as the plain version, before writing
    plan = scatter_plan((W,), D)
    launch = _launcher("row_scatter")
    with torch.cuda.device(dst.device):   # the launcher uses the current device
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        err = launch(dst.data_ptr(), S, W, rows.data_ptr(), upd.data_ptr(),
                     D, plan.threads, plan.k, stream)
    build.check(err, "row_scatter")
    build.LAUNCHES["row_scatter"] += 1
    return dst


def snapshot_image_scatter(image: torch.Tensor, rows: torch.Tensor,
                           upd: torch.Tensor) -> torch.Tensor:
    """image[rows[i], :] = upd[i, :] — ONE contiguous image-row copy per
    dirty node (the packed layout's whole sync), in place on CUDA."""
    return snapshot_delta_scatter(image, rows, upd)


def snapshot_multi_scatter(dsts, rows: torch.Tensor, upd) -> tuple:
    """dsts[f][rows[i], :] = upd[f][i, :] for every field f and dirty row
    i, in place on CUDA, in ONE launch (the legacy layout's delta sync).

    dsts: sequence of [S, W_f] resident field tensors (trailing dims
          flattened by the caller), 4-byte elements, the same S each
    rows: [D] int32 target rows (repeats allowed with identical data)
    upd:  matching sequence of [D, W_f] replacement rows, each of its
          field's dtype
    Returns ``dsts`` as a tuple."""
    dsts, upd = tuple(dsts), tuple(upd)
    nf = len(dsts)
    if not 1 <= nf <= MAX_FIELDS or len(upd) != nf:
        raise ValueError(f"need 1 to {MAX_FIELDS} fields with one update "
                         f"block each, got {nf} and {len(upd)}")
    build.check_tensor(rows, "rows", 1)
    if rows.dtype != torch.int32:
        raise ValueError("rows must be int32")
    S, D = dsts[0].shape[0], rows.shape[0]
    for f, (d, u) in enumerate(zip(dsts, upd)):
        build.check_tensor(d, f"dsts[{f}]", 2, rows.device)
        build.check_tensor(u, f"upd[{f}]", 2, rows.device)
        if u.dtype != d.dtype or d.element_size() != 4:
            raise ValueError(f"upd[{f}] is {u.dtype}, its field {d.dtype}: "
                             f"need one 4-byte dtype")
        if d.shape[0] != S or u.shape != (D, d.shape[1]):
            raise ValueError(f"field {f}: need dst [{S}, W] and upd "
                             f"[{D}, W], got {tuple(d.shape)} and "
                             f"{tuple(u.shape)}")
    widths = tuple(d.shape[1] for d in dsts)
    if D == 0 or sum(widths) == 0:
        return dsts
    ref.check_rows(rows, S)        # as the plain version, before writing
    plan = scatter_plan(widths, D)
    launch = _launcher("multi_scatter")
    ptrs = ctypes.c_void_p * nf
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = launch(
            ptrs(*(d.data_ptr() for d in dsts)),
            ptrs(*(u.data_ptr() for u in upd)),
            (ctypes.c_int * nf)(*widths), nf, S, rows.data_ptr(), D,
            plan.threads, plan.k, stream)
    build.check(err, "multi_scatter")
    build.LAUNCHES["multi_scatter"] += 1
    return dsts


def log_replay_scatter(image: torch.Tensor, rows: torch.Tensor,
                       slots: torch.Tensor, entries: torch.Tensor, *,
                       offs) -> torch.Tensor:
    """Replay one epoch's marshalled log entries into a resident packed
    node image, in place on CUDA (the log-shipped feed's device half).

    image:   [S, IW] int32 resident follower node images (u32 bit views)
    rows:    [D] int32 target physical slots (leaves that took appends)
    slots:   [D] int32 log slot index per entry, in [0, log_cap)
    entries: [D, key_words + val_words + 6] int32 marshalled records
    offs:    ``core/schema.LogReplayOffsets``
    Each touched row's ``nlog`` becomes its highest ``slots + 1`` in this
    call.  A row outside [-S, S) or a slot outside [0, log_cap) raises
    IndexError, as the plain version does, and the image is left as it
    was: the kernel checks every pair before any block writes, and the
    wrapper reads its verdict back once, after the launch.  Returns
    ``image``."""
    build.check_tensor(image, "image", 2)
    for t, name, nd in ((rows, "rows", 1), (slots, "slots", 1),
                        (entries, "entries", 2)):
        build.check_tensor(t, name, nd, image.device)
    if (image.dtype != torch.int32 or rows.dtype != torch.int32
            or slots.dtype != torch.int32 or entries.dtype != torch.int32):
        raise ValueError("image, rows, slots and entries must be int32")
    S, IW = image.shape
    D = rows.shape[0]
    EW = offs.key_words + offs.val_words + 6
    if slots.shape != (D,) or entries.shape != (D, EW):
        raise ValueError(f"need slots [{D}] and entries [{D}, {EW}], got "
                         f"{tuple(slots.shape)} and {tuple(entries.shape)}")
    if IW < offs.log_vdelta + offs.log_cap:
        raise ValueError(f"image rows of {IW} words do not hold the log "
                         f"fields at {offs}")
    if D == 0:
        return image
    plan = replay_plan(D, EW)
    flag = torch.empty(1, dtype=torch.int32, device=image.device)
    launch = _launcher("log_replay")
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = launch(
            image.data_ptr(), S, IW, rows.data_ptr(), slots.data_ptr(),
            entries.data_ptr(), D, EW, offs.log_cap, plan.entries,
            plan.threads, flag.data_ptr(), *offs, stream)
    build.check(err, "log_replay")
    build.LAUNCHES["log_replay"] += 1
    verdict = int(flag.item())     # the one read-back; nothing was written
    if verdict:                    # when it is bad: raise as the plain one
        ref.check_rows(rows, S)
        ref.check_slots(slots, offs.log_cap)
        raise RuntimeError(f"log_replay flagged {verdict} on rows and "
                           f"slots that the plain checks accept")
    return image
