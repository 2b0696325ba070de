"""Paged decode attention on the GPU (port of
``repro.kernels.paged_attention``).

The serving engine's KV cache lies in fixed-size pages whose ids come from
Honeycomb GETs on the page-table store (``serving/kv_cache.py``); each
decode step, every attention layer attends one new query token per
sequence to its pages through this kernel.  ``csrc/paged_attention.cu``
splits each sequence's positions into spans, one block per (sequence, KV
head, span), whose G = H // KVH query heads share every K/V element the
block reads; a second kernel combines the spans' partial softmax states.
``span_plan`` sizes the split from the static shapes alone, so a call
never reads ``seq_lens`` back to the host.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

#: the kernel keeps the G query heads' scores and four output dims a
#: thread for each head in registers
MAX_GROUP = 16
MAX_HEAD_DIM = 256

#: positions a span covers: 256 (about 140 live blocks on the H100's 132
#: SMs at the serving path's shapes: 8 sequences of 1,024-4,000 positions,
#: 2 KV heads) measured fastest of 64-512 there (PERF.md, section 6)
SPAN_POSITIONS = 256
#: tile sizes the kernel takes, largest first, and the shared memory its
#: ring of two stages may take (two blocks of 256 threads an SM)
TILES = (64, 32, 16)
RING_BUDGET = 72 * 1024
#: a third stage while two blocks still fit an SM (228 KB, 1 KB reserved
#: a block)
THREE_STAGE_BUDGET = 113 * 1024
MAX_SMEM = 232448            # 227 KB, the most a block may use
MAX_WORKSPACE = 64 << 20     # bytes of partial state a call may allocate
THREADS = 256                # a split block


class SpanPlan(NamedTuple):
    """How a call splits the positions: spans of ``span`` positions
    (``n_spans`` cover PPS * P), walked in tiles of ``tile`` positions
    through a ring of ``stages`` shared-memory stages; ``smem`` bytes of
    shared memory a block."""
    span: int
    n_spans: int
    tile: int
    stages: int
    smem: int


def group_tile(G: int) -> int:
    """The kernel's head template: G rounded up to a power of two."""
    gt = 1
    while gt < G:
        gt *= 2
    return gt


def smem_bytes(G: int, D: int, tile: int, stages: int, elem: int) -> int:
    """Shared memory of one split block (``csrc/paged_attention.cu:
    smem_bytes``): the ring of K and V tiles, rows padded by 16 bytes,
    which the phases' partial sums reuse at the end; then q, the tile's
    scores and probabilities and the rescale factors in f32, q in bf16 as
    the tensor cores' 16 rows, and the span's page ids."""
    gt = group_tile(G)
    red = (THREADS // (D // 4)) * gt * D * 4
    return max(ring_bytes(D, tile, stages, elem), red) \
        + 4 * (gt * D + 2 * gt * tile + gt) + 2 * 16 * (D + 8) \
        + 4 * THREADS


def ring_bytes(D: int, tile: int, stages: int, elem: int) -> int:
    """The K and V tiles of every stage, rows padded by 16 bytes."""
    return stages * 2 * tile * (D + 16 // elem) * elem


def span_plan(B: int, H: int, KVH: int, PPS: int, P: int, D: int,
              kv_dtype: torch.dtype) -> SpanPlan:
    """The split of a call at these shapes, from the static sizes alone
    (the visible lengths live on the device and are not read): spans of
    ``SPAN_POSITIONS`` rounded up to whole tiles, longer where the partial
    state or the grid would grow too large."""
    G = H // KVH
    elem = 2 if kv_dtype == torch.bfloat16 else 4
    tile = next((t for t in TILES if ring_bytes(D, t, 2, elem)
                 <= RING_BUDGET), TILES[-1])
    total = PPS * P
    whole = -(-total // tile) * tile          # every position, in tiles
    span = min(-(-SPAN_POSITIONS // tile) * tile, whole)
    # bound the partial state and the grid: fewer, longer spans
    while span < whole and (
            B * KVH * -(-total // span) * G * (D + 2) * 4 > MAX_WORKSPACE
            or -(-total // span) > 65535):
        span = min(2 * span, whole)
    stages = 2
    if span // tile >= 3 and smem_bytes(G, D, tile, 3, elem) \
            <= THREE_STAGE_BUDGET:
        stages = 3
    return SpanPlan(span, -(-total // span), tile, stages,
                    smem_bytes(G, D, tile, stages, elem))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k_pages, v_pages, block_tables, seq_lens, start_pos, out, ws,
# B, H, KVH, D, P, PPS, q_bf16, kv_bf16, span, n_spans, tile, stages,
# scale, softcap, stream
_ARGTYPES = [_P] * 8 + [_I] * 12 + [_F] * 2 + [_P]
_FLOATS = (torch.float32, torch.bfloat16)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, start_pos=None, *,
                    scale: float | None = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over paged KV, on CUDA.

    q:            [B, H, D] float32 or bfloat16, one token per sequence
    k_pages, v_pages: [NP, P, KVH, D], one type, float32 or bfloat16
    block_tables: [B, PPS] int32 page ids, each in [0, NP) (not checked
                  here: that would cost a device sync per call)
    seq_lens:     [B] int32 visible tokens (exclusive upper bound)
    start_pos:    [B] int32 first visible position (sliding window);
                  None means 0
    Returns [B, H, D] of q's type; a sequence with no visible position
    gets zeros."""
    dev = q.device
    build.check_tensor(q, "q", 3)
    build.check_tensor(k_pages, "k_pages", 4, dev)
    build.check_tensor(v_pages, "v_pages", 4, dev, k_pages.dtype)
    for t, name in ((q, "q"), (k_pages, "k_pages")):
        if t.dtype not in _FLOATS:
            raise ValueError(f"{name} must be float32 or bfloat16, "
                             f"got {t.dtype}")
    B, H, D = q.shape
    NP, P, KVH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"need k_pages and v_pages [NP, P, KVH, {D}], got "
                         f"{tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    if KVH < 1 or H % KVH or not 1 <= H // KVH <= MAX_GROUP:
        raise ValueError(f"H = {H} must be a multiple of KVH = {KVH}, at "
                         f"most {MAX_GROUP} query heads a KV head")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the kernel takes a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    build.check_tensor(block_tables, "block_tables", 2, dev, torch.int32)
    if block_tables.shape[0] != B:
        raise ValueError(f"block_tables must have {B} rows, got "
                         f"{block_tables.shape[0]}")
    if start_pos is None:
        start_pos = torch.zeros_like(seq_lens)
    for t, name in ((seq_lens, "seq_lens"), (start_pos, "start_pos")):
        build.check_tensor(t, name, 1, dev, torch.int32)
        if t.shape[0] != B:
            raise ValueError(f"{name} must have {B} entries, got "
                             f"{t.shape[0]}")
    for t, name in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    plan = span_plan(B, H, KVH, block_tables.shape[1], P, D, k_pages.dtype)
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, start_pos,
                   plan, float(scale), float(softcap))


def _launch(q, k_pages, v_pages, block_tables, seq_lens, start_pos,
            plan: SpanPlan, scale: float, softcap: float) -> torch.Tensor:
    """Launch the split and combining kernels on inputs that
    ``paged_attention`` has checked, with the given plan."""
    B, H, D = q.shape
    _, P, KVH, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    dev = q.device
    ws = torch.empty(B * KVH * plan.n_spans * (H // KVH) * (D + 2),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.launcher("paged_attention", "paged_attention_launch",
                             _ARGTYPES)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(),
            start_pos.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, KVH,
            D, P, block_tables.shape[1], int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16), plan.span, plan.n_spans,
            plan.tile, plan.stages, scale, softcap, stream)
    build.check(err, "paged_attention")
    build.LAUNCHES["paged_attention"] += 1
    return out
