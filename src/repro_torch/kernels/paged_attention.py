"""Paged decode attention on the GPU (port of
``repro.kernels.paged_attention``).

The serving engine's KV cache lies in fixed-size pages whose ids come from
Honeycomb GETs on the page-table store (``serving/kv_cache.py``); each
decode step, every attention layer attends one new query token per
sequence to its pages through this kernel.  ``csrc/paged_attention.cu``
runs one block per (sequence, KV head); its G = H // KVH query heads share
every K/V element the block reads.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: the kernel keeps the G query heads' scores and two output dims a thread
#: for each head in registers
MAX_GROUP = 16
MAX_HEAD_DIM = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k_pages, v_pages, block_tables, seq_lens, start_pos, out,
# B, H, KVH, D, P, PPS, q_bf16, kv_bf16, scale, softcap, stream
_ARGTYPES = [_P] * 7 + [_I] * 8 + [_F] * 2 + [_P]
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
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.launcher("paged_attention", "paged_attention_launch",
                             _ARGTYPES)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(),
            start_pos.data_ptr(), out.data_ptr(), B, H, KVH, D, P,
            block_tables.shape[1], int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16), float(scale),
            float(softcap), stream)
    build.check(err, "paged_attention")
    build.LAUNCHES["paged_attention"] += 1
    return out
