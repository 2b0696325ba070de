"""Delta-sync row scatter on the GPU (port of
``repro.kernels.delta_scatter.snapshot_delta_scatter`` /
``snapshot_image_scatter``).

One sync's dirty node rows arrive as a dense [D, W] update block plus a
[D] row-index vector; the kernel (``csrc/row_scatter.cu``) copies each
update row over the matching row of the resident [S, W] image in place.
This is the device half of the PCIe analogue: the host ships O(dirty)
bytes and the device image is patched, never rebuilt.  Repeated rows must
carry identical data, which keeps the scatter order-free.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("row_scatter")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.row_scatter_launch.argtypes = [p, i, i, p, p, i, p]
        lib.row_scatter_launch.restype = i
        _LIB = lib
    return _LIB


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
    S, W = dst.shape
    D = rows.shape[0]
    if upd.shape != (D, W):
        raise ValueError(f"upd must be [{D}, {W}], got {tuple(upd.shape)}")
    if D == 0:
        return dst
    ref.check_rows(rows, S)        # as the plain version, before writing
    lib = _lib()
    with torch.cuda.device(dst.device):   # the launcher uses the current device
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        err = lib.row_scatter_launch(dst.data_ptr(), S, W, rows.data_ptr(),
                                     upd.data_ptr(), D, stream)
    build.check(err, "row_scatter")
    build.LAUNCHES["row_scatter"] += 1
    return dst


def snapshot_image_scatter(image: torch.Tensor, rows: torch.Tensor,
                           upd: torch.Tensor) -> torch.Tensor:
    """image[rows[i], :] = upd[i, :] — ONE contiguous image-row copy per
    dirty node (the packed layout's whole sync), in place on CUDA."""
    return snapshot_delta_scatter(image, rows, upd)
