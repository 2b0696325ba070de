"""Fused device-resident GET/SCAN on the GPU (port of
``repro.kernels.fused_read``).

One launch executes the WHOLE per-request traversal for a batch —
cache-tiered descend over the packed node image, leaf resolve, order-hint
log merge, MVCC version resolution — where the reference path
(core/read_path.py) issues a stage of tensor ops per level and per leaf.
The kernel (``csrc/fused_read.cu``) runs one warp per request; its design
notes and its bound are in the source.  It computes exactly what
``kernels/ref.py:batched_{get,scan}_fused_ref`` compute, including the
``[vmem_hits, heap_gathers, lb_routed]`` meters summed over the batch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.read_path import GetResult, ScanResult, TreeSnapshot
from ..core.schema import FIELD_NAMES, NodeImageLayout
from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I,
              _I, _I] + [_P] * 10)

#: requests a block serves, one warp each (csrc/fused_read.cu WARPS)
WARPS = 2
#: the most dynamic shared memory the launcher lets a block take
#: (csrc/fused_read.cu MAX_SMEM: 227 KB)
MAX_SMEM = 232448


def warp_words(cfg) -> int:
    """Shared-memory words one warp needs (csrc/fused_read.cu
    ``warp_words``): the query's lo and hi keys, one staged row, the
    merge's four [N + L] arrays, the result slots and the floor item."""
    KW, VW = cfg.key_words, cfg.val_words
    return (2 * KW + NodeImageLayout.for_config(cfg).image_words
            + 4 * (cfg.node_cap + cfg.log_cap)
            + cfg.max_scan_items * (KW + VW + 2) + KW + VW)


def smem_bytes(cfg, C: int) -> int:
    """Dynamic shared memory of one block over a cache of C rows
    (csrc/fused_read.cu ``block_smem_bytes``, which the launcher asks for):
    the cache LIDs, the root row, then each warp's words."""
    IW = NodeImageLayout.for_config(cfg).image_words
    return (C + IW + WARPS * warp_words(cfg)) * 4


def bytes_moved(cfg, rows_read: float, batch: int, scan: bool = False
                ) -> float:
    """The least bytes one GET (or SCAN) batch of ``batch`` requests must
    move, the kernel's byte bound: the ``rows_read`` distinct image and
    cache rows its walk reads (the sum of its ``touched`` marks) read
    once, its keys and lengths (lo and hi for a SCAN) read, and its
    outputs written: found, length and value (a SCAN: count, trunc and
    ``max_scan_items`` keys, values and lengths)."""
    IW = NodeImageLayout.for_config(cfg).image_words
    KW, VW = cfg.key_words, cfg.val_words
    keys_in = batch * (KW + 1) * 4 * (2 if scan else 1)
    out = batch * 4 * ((2 + cfg.max_scan_items * (KW + VW + 2)) if scan
                       else (VW + 2))
    return rows_read * IW * 4 + keys_in + out


def launcher_smem_bytes(cfg, C: int) -> int:
    """The launcher's own figure for ``smem_bytes`` (builds the kernel's
    library where the CUDA toolkit is installed)."""
    geo = _geometry(cfg)
    f = build.launcher("fused_read", "fused_read_smem_bytes", [_P, _I, _I])
    return int(f(geo.ctypes.data, len(geo), C))


def _geometry(cfg) -> np.ndarray:
    """The kernel's Geo struct: dimensions, static bounds, then the packed
    image word offset of every field in schema order (the struct declares
    them in that order)."""
    layout = NodeImageLayout.for_config(cfg)
    dims = (layout.image_words, cfg.node_cap, cfg.log_cap, cfg.n_shortcuts,
            cfg.key_words, cfg.val_words, cfg.segment_items,
            cfg.max_scan_items, cfg.max_height, cfg.max_version_chain,
            cfg.max_scan_leaves)
    offs = tuple(layout.slots[f].offset for f in FIELD_NAMES)
    return np.asarray(dims + offs, np.int32)


def _launch(get: bool, snap: TreeSnapshot, lo, lolen, hi, hilen, cfg,
            lb_fraction: float, touched=None, loads=None):
    image = snap.image
    dev = image.device
    build.check_tensor(image, "image", 2)
    S, IW = image.shape
    if IW != NodeImageLayout.for_config(cfg).image_words:
        raise ValueError(f"image rows hold {IW} words, the layout "
                         f"{NodeImageLayout.for_config(cfg).image_words}")
    if snap.cache_lids is None or snap.cache_image is None:
        raise ValueError("the fused read needs the snapshot's cache tier")
    for name, t, nd in (("pagetable", snap.pagetable, 1),
                        ("cache_lids", snap.cache_lids, 1),
                        ("cache_image", snap.cache_image, 2),
                        ("lo", lo, 2), ("lolen", lolen, 1),
                        ("hi", hi, 2), ("hilen", hilen, 1)):
        build.check_tensor(t, name, nd, dev)
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    B = lo.shape[0]
    C = snap.cache_lids.shape[0]
    KW, VW, M = cfg.key_words, cfg.val_words, cfg.max_scan_items
    if snap.cache_image.shape != (C, IW):
        raise ValueError("cache_image must be [C, image_words]")
    for name, t, shape in (("lo", lo, (B, KW)), ("lolen", lolen, (B,)),
                           ("hi", hi, (B, KW)), ("hilen", hilen, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t, n in (("touched", touched, S + C), ("loads", loads, B)):
        if t is not None:
            build.check_tensor(t, name, 1, dev)
            if t.dtype != torch.int32 or t.shape[0] != n:
                raise ValueError(f"{name} must be int32 [{n}]")

    i32 = dict(dtype=torch.int32, device=dev)
    if get:
        outs = [torch.empty(B, **i32), torch.empty(B, VW, **i32),
                torch.empty(B, **i32)]
    else:
        outs = [torch.empty(B, **i32), torch.empty(B, M, KW, **i32),
                torch.empty(B, M, **i32), torch.empty(B, M, VW, **i32),
                torch.empty(B, M, **i32), torch.empty(B, **i32)]
    meters = torch.empty(B, 3, **i32)
    ptrs = [t.data_ptr() for t in outs] + [None] * (6 - len(outs))
    geo = _geometry(cfg)
    launch = build.launcher("fused_read", "fused_read_launch", _ARGTYPES)
    with torch.cuda.device(dev):   # the launcher uses the current device
        err = launch(
            int(get), geo.ctypes.data, len(geo), image.data_ptr(), S,
            snap.pagetable.data_ptr(), snap.pagetable.shape[0],
            snap.cache_lids.data_ptr(), snap.cache_image.data_ptr(), C,
            lo.data_ptr(), lolen.data_ptr(), hi.data_ptr(), hilen.data_ptr(),
            B, int(snap.root_lid), int(snap.read_version),
            int(round(lb_fraction * 16)), *ptrs, meters.data_ptr(),
            None if touched is None else touched.data_ptr(),
            None if loads is None else loads.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_read")
    build.LAUNCHES["fused_get" if get else "fused_scan"] += 1
    return outs, meters.sum(dim=0, dtype=torch.int32)


def batched_scan_fused(snap: TreeSnapshot, lo, lolen, hi, hilen, *, cfg,
                       lb_fraction: float = 0.0, touched=None, loads=None):
    """Fused SCAN(K_l, K_u): ONE launch for the whole batch.  Returns
    (ScanResult, meters i32[3]) equal to ``ref.batched_scan_fused_ref``.
    ``touched`` ([S + C] int32 zeros) and ``loads`` ([B] int32), when
    given, receive the rows the batch read and each request's count of
    dependent row reads."""
    (count, keys, klens, vals, vlens, trunc), meters = _launch(
        False, snap, lo, lolen, hi, hilen, cfg, lb_fraction, touched, loads)
    return ScanResult(count, keys, klens, vals, vlens, trunc != 0), meters


def batched_get_fused(snap: TreeSnapshot, key, klen, *, cfg,
                      lb_fraction: float = 0.0, touched=None, loads=None):
    """Fused GET(K): ONE launch for the whole batch.  Returns
    (GetResult, meters i32[3]) equal to ``ref.batched_get_fused_ref``."""
    (found, vals, vlens), meters = _launch(
        True, snap, key, klen, key, klen, cfg, lb_fraction, touched, loads)
    return GetResult(found != 0, vals, vlens), meters
