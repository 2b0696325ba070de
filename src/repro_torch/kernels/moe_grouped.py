"""The grouped expert FFN of prefill's MoE layers on the GPU: each token
through its top-k experts only (``csrc/moe_grouped.cu``).

The reference computes its ragged MoE with ``jax.lax.ragged_dot``, no
Pallas kernel; the port's ``models/moe.py:moe_ragged`` loops over the
experts with ``torch.matmul`` and reads the group sizes back.  This
module replaces neither: it is the forward-only grouped product that
``models/moe.py:moe_grouped`` runs in prefill, in five launches that read
nothing back to the host (dispatch, row gather, gate/up, down, combine),
each counted in ``build.LAUNCHES["moe_grouped"]``.  Its plain version
(``moe_grouped_plain`` and the stages it is made of) repeats the
kernels' dispatch, rounding and f32 combine; ``kernels/ops.moe_grouped``
runs it for CPU tensors and launches the kernels for CUDA tensors.

The products take the wgmma kernels for bf16 at tile-exact widths (d a
multiple of 256, f of 128: every configuration the port serves at full
width) and the SIMT kernels otherwise (f32, the smoke widths): the
choice follows the tensors' type and shapes alone.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: rows a row tile: the wgmma kernels' (two warpgroups of 64) and the SIMT
#: kernels' (``csrc/moe_grouped.cu``: kBM, kSBM)
WGMMA_ROWS = 128
SIMT_ROWS = 64
#: the dispatch kernel stages the expert ids as bytes in shared memory,
#: beside its per-warp counts (32 warps x MAX_EXPERTS) and the experts'
#: offsets, all int32
MAX_EXPERTS = 256
MAX_PAIRS = 190_000
#: the wgmma products' ring: 4 stages of A (128 x 64) and B (64 x 256) in
#: bf16, a full and an empty mbarrier a stage, 1,024 bytes to align
WGMMA_SMEM = 4 * (128 * 64 + 64 * 256) * 2 + 2 * 4 * 8 + 1024


def dispatch_smem_bytes(pairs: int) -> int:
    """Shared memory of the dispatch block: ``pairs`` bytes of ids and
    its static counts (``csrc/moe_grouped.cu: moe_dispatch_kernel``)."""
    return pairs + 4 * (32 * MAX_EXPERTS + MAX_EXPERTS)

_P, _I = ctypes.c_void_p, ctypes.c_int
_DISPATCH = [_P] * 3 + [_I] * 3 + [_P]       # ids, pos, meta, n, E, bm, st
_GATHER = [_P] * 3 + [_I] * 4 + [_P]         # x, pos, xs, T, k, d, bf, st
_GEMM = [_P] * 5 + [_I] * 7 + [_P]           # a, b0, b1, meta, out, rows,
#                                              E, K, N, mode, bf, wgmma, st
_COMBINE = [_P] * 4 + [_I] * 4 + [_P]        # y, pos, gates, out, T, k, d,
#                                              bf, st


def uses_wgmma(dtype: torch.dtype, d: int, f: int) -> bool:
    """The wgmma kernels take bf16 at whole tiles: gate/up's 128 columns
    of f, down's 256 of d, 64 of K in both."""
    return dtype == torch.bfloat16 and d % 256 == 0 and f % 128 == 0


# --- the plain version ------------------------------------------------------
def dispatch_plain(ids: torch.Tensor, n_experts: int, bm: int):
    """The stable expert-sorted order of the (token, slot) pairs, as the
    dispatch kernel gives it: (pos [n] int32, each pair's sorted row;
    meta [2 (E + 1)] int32, each expert's first row then its first row
    tile of ``bm`` rows, each with the total last)."""
    eid = ids.reshape(-1)
    order = torch.argsort(eid, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(eid.numel(), device=eid.device)
    counts = torch.bincount(eid, minlength=n_experts)
    zero = counts.new_zeros(1)
    meta = torch.cat([zero, counts.cumsum(0), zero,
                      ((counts + bm - 1) // bm).cumsum(0)])
    return pos.int(), meta.int()


def gather_plain(x2d: torch.Tensor, pos: torch.Tensor, k: int):
    """xs [T * k, d]: token t's row at its k sorted rows."""
    xs = x2d.new_empty(x2d.shape[0] * k, x2d.shape[1])
    xs[pos.long()] = x2d.repeat_interleave(k, dim=0)
    return xs


def ffn_plain(xs, meta, w_gate, w_up, w_down):
    """(h, y) of rows sorted by expert (``ref.routed_ffn``, the training
    MoE's loop), each expert's rows read from meta."""
    E = w_gate.shape[0]
    return ref.routed_ffn(xs, w_gate, w_up, w_down,
                          (meta[1:E + 1] - meta[:E]).tolist())


def combine_plain(y: torch.Tensor, pos: torch.Tensor, gates: torch.Tensor):
    """out[t] = sum over j of gates[t, j] * f32(y[pos[t, j]]), in f32 in
    slot order, rounded to y's type.  gates: [T, k] f32."""
    T, k = gates.shape
    rows = pos.reshape(T, k).long()
    acc = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    for j in range(k):
        acc = acc + gates[:, j:j + 1] * y[rows[:, j]].float()
    return acc.to(y.dtype)


def moe_grouped_plain(x2d, gates, ids, w_gate, w_up, w_down):
    """The plain grouped FFN: x2d [T, d], gates [T, k] f32, ids [T, k]
    int64 -> [T, d] of x2d's type."""
    T, k = ids.shape
    pos, meta = dispatch_plain(ids, w_gate.shape[0], WGMMA_ROWS)
    _, y = ffn_plain(gather_plain(x2d, pos, k), meta, w_gate, w_up, w_down)
    return combine_plain(y, pos, gates)


# --- the kernels --------------------------------------------------------------
def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def dispatch(ids: torch.Tensor, n_experts: int, bm: int):
    """``dispatch_plain`` on the card, one launch: ids [T, k] int64."""
    if ids.dtype != torch.int64 or not ids.is_contiguous() \
            or ids.device.type != "cuda":
        raise ValueError("ids must be a contiguous CUDA int64 tensor")
    n = ids.numel()
    if not 1 <= n_experts <= MAX_EXPERTS or n > MAX_PAIRS:
        raise ValueError(f"the dispatch kernel takes up to {MAX_EXPERTS} "
                         f"experts and {MAX_PAIRS} pairs, got {n_experts} "
                         f"and {n}")
    dev = ids.device
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    meta = torch.empty(2 * (n_experts + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.launcher("moe_grouped", "moe_dispatch_launch", _DISPATCH)(
            ids.data_ptr(), pos.data_ptr(), meta.data_ptr(), n, n_experts,
            bm, _stream(dev))
    build.check(err, "moe_dispatch")
    build.LAUNCHES["moe_grouped"] += 1
    return pos, meta


def gather(x2d: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """``gather_plain`` on the card, one launch."""
    T, d = x2d.shape
    xs = torch.empty(T * k, d, dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        err = build.launcher("moe_grouped", "moe_gather_launch", _GATHER)(
            x2d.data_ptr(), pos.data_ptr(), xs.data_ptr(), T, k, d,
            int(x2d.dtype == torch.bfloat16), _stream(x2d.device))
    build.check(err, "moe_gather")
    build.LAUNCHES["moe_grouped"] += 1
    return xs


def grouped_gemm(a, meta, b0, b1, mode: int, wgmma: bool) -> torch.Tensor:
    """One grouped product on the card: mode 0 h = swiglu(a b0[e], a
    b1[e]), mode 1 y = a b0[e], over a's rows sorted by expert (meta from
    ``dispatch`` with the kernel's row tile)."""
    rows, K = a.shape
    E, Kb, N = b0.shape
    if Kb != K:
        raise ValueError(f"weights [E, {Kb}, N] against rows of {K}")
    out = torch.empty(rows, N, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = build.launcher("moe_grouped", "moe_grouped_gemm_launch",
                             _GEMM)(
            a.data_ptr(), b0.data_ptr(), b1.data_ptr(), meta.data_ptr(),
            out.data_ptr(), rows, E, K, N, mode,
            int(a.dtype == torch.bfloat16), int(wgmma), _stream(a.device))
    build.check(err, "moe_grouped_gemm")
    build.LAUNCHES["moe_grouped"] += 1
    return out


def combine(y: torch.Tensor, pos: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """``combine_plain`` on the card, one launch."""
    T, k = gates.shape
    d = y.shape[1]
    out = torch.empty(T, d, dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        err = build.launcher("moe_grouped", "moe_combine_launch", _COMBINE)(
            y.data_ptr(), pos.data_ptr(), gates.data_ptr(), out.data_ptr(),
            T, k, d, int(y.dtype == torch.bfloat16), _stream(y.device))
    build.check(err, "moe_combine")
    build.LAUNCHES["moe_grouped"] += 1
    return out


def _check(x2d, gates, ids, w_gate, w_up, w_down) -> None:
    dev = x2d.device
    T, d = x2d.shape
    E, _, f = w_gate.shape
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x2d.dtype}")
    for t, name, shape in ((w_gate, "w_gate", (E, d, f)),
                           (w_up, "w_up", (E, d, f)),
                           (w_down, "w_down", (E, f, d))):
        build.check_tensor(t, name, 3, dev, x2d.dtype)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    build.check_tensor(x2d, "x", 2, dev)
    build.check_tensor(gates, "gates", 2, dev, torch.float32)
    if gates.shape != ids.shape or ids.shape[0] != T:
        raise ValueError(f"gates and ids must be [{T}, k], got "
                         f"{list(gates.shape)} and {list(ids.shape)}")
    if (d * x2d.element_size()) % 16:
        raise ValueError(f"d = {d}: rows must be whole 16-byte vectors")
    for t, name in ((x2d, "x"), (w_gate, "w_gate"), (w_up, "w_up"),
                    (w_down, "w_down")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def moe_grouped(x2d, gates, ids, w_gate, w_up, w_down) -> torch.Tensor:
    """The grouped FFN on the card: x2d [T, d], gates [T, k] f32 (the
    router's top-k weights), ids [T, k] int64 (its experts), weights [E,
    d, f], [E, d, f], [E, f, d] -> [T, d] of x2d's type, in five launches
    that read nothing back to the host.  ``kernels/ops.moe_grouped`` runs
    ``moe_grouped_plain`` for CPU tensors."""
    _check(x2d, gates, ids, w_gate, w_up, w_down)
    T, d = x2d.shape
    if T == 0:
        return torch.empty_like(x2d)
    k = ids.shape[1]
    f = w_gate.shape[-1]
    wgmma = uses_wgmma(x2d.dtype, d, f)
    pos, meta = dispatch(ids, w_gate.shape[0],
                         WGMMA_ROWS if wgmma else SIMT_ROWS)
    xs = gather(x2d, pos, k)
    h = grouped_gemm(xs, meta, w_gate, w_up, 0, wgmma)
    y = grouped_gemm(h, meta, w_down, w_down, 1, wgmma)
    return combine(y, pos, gates)
