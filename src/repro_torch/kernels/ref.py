"""Plain PyTorch versions of the hand-written kernels (port of the
main-path oracles in ``repro.kernels.ref``).

The kernel wrappers (``delta_scatter.py``, ``fused_read.py``) are held to
these bit for bit, and ``ops.py`` runs them for tensors on the CPU.
"""
from __future__ import annotations

import torch

from ..core import read_path as _rp


def check_rows(rows: torch.Tensor, n: int) -> None:
    """Raise IndexError unless every row lies in [-n, n) (negative rows
    wrap Python-style); the scatter and its kernel call it before they
    write anything."""
    if rows.numel():
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()
        if lo < -n or hi >= n:
            raise IndexError(f"rows must lie in [{-n}, {n}), got [{lo}, {hi}]")


def snapshot_delta_scatter_ref(dst: torch.Tensor, rows: torch.Tensor,
                               upd: torch.Tensor) -> torch.Tensor:
    """Delta-sync row scatter, in place: dst[rows[i]] = upd[i]; returns
    ``dst``.  Duplicate rows must carry identical data (the store pads
    deltas with repeats), so application order is immaterial."""
    check_rows(rows, dst.shape[0])
    dst[rows.long()] = upd
    return dst


def snapshot_image_scatter_ref(image: torch.Tensor, rows: torch.Tensor,
                               upd: torch.Tensor) -> torch.Tensor:
    """Packed node-image row scatter, in place: image[rows[i]] = upd[i] —
    one whole node image per dirty row (same duplicates contract)."""
    return snapshot_delta_scatter_ref(image, rows, upd)


def batched_scan_fused_ref(snap, lo, lolen, hi, hilen, *, cfg,
                           lb_fraction: float = 0.0):
    """Fused SCAN: the whole traversal — cache-tiered descend, leaf
    resolve, log merge, version resolution — over the snapshot's combined
    cache+heap view.  Returns (ScanResult, meters i32[3] =
    [vmem_hits, heap_gathers, lb_routed])."""
    view = _rp.fused_view(snap, cfg)
    leaf0, meters = _rp.descend_fused(snap, view, lo, lolen, cfg,
                                      lb_fraction=lb_fraction)
    res = _rp.scan_from_leaf(view, leaf0, lo, lolen, hi, hilen, cfg)
    return res, meters


def batched_get_fused_ref(snap, key, klen, *, cfg, lb_fraction: float = 0.0):
    """Fused GET: fused SCAN(K, K) + the shared equality post-pass.
    Returns (GetResult, meters i32[3])."""
    res, meters = batched_scan_fused_ref(snap, key, klen, key, klen,
                                         cfg=cfg, lb_fraction=lb_fraction)
    return _rp.get_from_scan(res, key, klen), meters
