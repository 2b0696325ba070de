"""RSU leaf merge on the GPU (port of ``repro.kernels.leaf_merge``).

The leaf-node scan unit (paper Section 4.3) orders a leaf's sorted block
and unsorted log block without comparing keys: the log block's order
hints drive a shift-register sort, each log entry's back pointer places it
before a sorted item, and the merged ranks give the emission permutation.
``csrc/leaf_merge.cu`` places each slot by an O(T * L) count against the
log ranks; ``merge_plan`` picks its instance: up to 16 log entries (the
stores' log blocks) a half-warp a leaf holds them in registers, beyond
that one warp a leaf keeps them in shared memory.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build

#: the wrapper takes node_cap + 2 * log_cap <= MAX_SHARED_WORDS, the
#: domain of the first kernel (its shared-memory budget), kept so that no
#: input it took is refused; the generic instance needs 12 * log_cap bytes
#: a leaf, two leaves a block, within the 48 KB a block gets without
#: opting in
MAX_SHARED_WORDS = 3072
#: warps a block of the register instance
MERGE_WARPS = 4
#: warps (leaves) a block of the generic instance
GENERIC_WARPS = 2

_P, _I = ctypes.c_void_p, ctypes.c_int
# nitems, nlog, backptr, hints, perm, valid, B, N, L, group, warps, stream
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """How ``csrc/leaf_merge.cu`` takes leaves of ``node_cap`` sorted and
    ``log_cap`` log slots: ``group`` 16 lanes a leaf holding its log
    entries and ranks in registers (``log_cap`` <= 16), or 0 for the
    generic instance (one warp a leaf, the entries in shared memory);
    ``warps`` a block, ``leaves`` a block; ``smem_bytes`` is the block's
    shared memory."""
    node_cap: int
    log_cap: int
    group: int
    warps: int
    leaves: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def merge_plan(node_cap: int, log_cap: int) -> MergePlan:
    """The merge's plan: a half-warp a leaf up to 16 log entries (two
    leaves a warp), the generic instance beyond."""
    if node_cap < 0 or log_cap < 0 \
            or node_cap + 2 * log_cap > MAX_SHARED_WORDS:
        raise ValueError(f"node_cap={node_cap}, log_cap={log_cap}: the "
                         f"kernel takes node_cap + 2 * log_cap <= "
                         f"{MAX_SHARED_WORDS}")
    if log_cap > 16:
        return MergePlan(node_cap, log_cap, 0, GENERIC_WARPS, GENERIC_WARPS,
                         12 * GENERIC_WARPS * log_cap)
    return MergePlan(node_cap, log_cap, 16, MERGE_WARPS, 2 * MERGE_WARPS, 0)


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
    plan = merge_plan(N, L)
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
            plan.group, plan.warps, stream)
    build.check(err, "leaf_merge")
    build.LAUNCHES["leaf_merge"] += 1
    return perm, valid
