"""RSU leaf merge on the GPU (port of ``repro.kernels.leaf_merge``).

The leaf-node scan unit (paper Section 4.3) orders a leaf's sorted block
and unsorted log block without comparing keys: the log block's order
hints drive a shift-register sort, each log entry's back pointer places it
before a sorted item, and the merged ranks give the emission permutation.
``csrc/leaf_merge.cu`` runs one warp per leaf.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: the kernel keeps N + 2L words a leaf in shared memory, four leaves a
#: block, within the 48 KB a block gets without opting in
MAX_SHARED_WORDS = 3072

_P, _I = ctypes.c_void_p, ctypes.c_int
# nitems, nlog, backptr, hints, perm, valid, B, N, L, stream
_ARGTYPES = [_P] * 6 + [_I] * 3 + [_P]


def leaf_merge(nitems: torch.Tensor, nlog: torch.Tensor,
               backptr: torch.Tensor, hints: torch.Tensor, *, node_cap: int,
               log_cap: int):
    """Merged emission permutation of a batch of leaves, on CUDA.

    nitems, nlog:   [B] int32 live sorted items and log entries
    backptr, hints: [B, log_cap] int32
    Returns (perm, valid), each [B, T] int32 with T = node_cap + log_cap:
    ``perm[b, p]`` is the slot (sorted block, then log block) emitted at
    merged position p, in all T positions (unused slots last, in slot
    order), and ``valid`` marks the used slots."""
    build.check_tensor(nitems, "nitems", 1, dtype=torch.int32)
    for t, name, nd in ((nlog, "nlog", 1), (backptr, "backptr", 2),
                        (hints, "hints", 2)):
        build.check_tensor(t, name, nd, nitems.device, torch.int32)
    B, N, L = nitems.shape[0], node_cap, log_cap
    if (nlog.shape != (B,) or backptr.shape != (B, L)
            or hints.shape != (B, L)):
        raise ValueError(f"need nlog [{B}], backptr and hints [{B}, {L}], "
                         f"got {tuple(nlog.shape)}, {tuple(backptr.shape)} "
                         f"and {tuple(hints.shape)}")
    if N < 0 or L < 0 or N + 2 * L > MAX_SHARED_WORDS:
        raise ValueError(f"node_cap={N}, log_cap={L}: the kernel takes "
                         f"node_cap + 2 * log_cap <= {MAX_SHARED_WORDS}")
    T = N + L
    perm = torch.empty(B, T, dtype=torch.int32, device=nitems.device)
    valid = torch.empty_like(perm)
    if B == 0 or T == 0:
        return perm, valid
    with torch.cuda.device(nitems.device):
        stream = torch.cuda.current_stream(nitems.device).cuda_stream
        err = build.launcher("leaf_merge", "leaf_merge_launch", _ARGTYPES)(
            nitems.data_ptr(), nlog.data_ptr(), backptr.data_ptr(),
            hints.data_ptr(), perm.data_ptr(), valid.data_ptr(), B, N, L,
            stream)
    build.check(err, "leaf_merge")
    build.LAUNCHES["leaf_merge"] += 1
    return perm, valid
