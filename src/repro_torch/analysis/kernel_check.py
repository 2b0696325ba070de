"""Kernel dispatch audit — the CUDA counterpart of the reference's jaxpr
audit (port of ``repro.analysis.kernel_check``).

A jaxpr can be checked without running anything; a ctypes launch cannot
be looked into.  So each entry point of ``kernels/ops.py`` runs ONCE on
small seeded inputs and its dispatch is recorded (``DispatchRecord``):

  * the dtypes of every aten op's inputs and outputs
    (``torch.utils._python_dispatch.TorchDispatchMode``);
  * ``build.LAUNCHES`` before and after;
  * whether the result is the destination's own storage;
  * on the card, the device -> host read-backs
    (``torch.cuda.set_sync_debug_mode("warn")`` warns once per
    synchronizing call) and the peak allocation during the dispatch;
  * the dynamic shared memory its launches ask for, from the plans that
    size them, at the store's default ``HoneycombConfig`` (the dispatch's
    shapes where the kernel has no store geometry) and at each plan's
    largest admitted shape.

``check_record`` is a pure function of one record, as ``check_jaxpr`` is
of a jaxpr, so tests feed it deliberately broken records.  Rules:

  * ``kernel-no-f64`` — no float64/complex128 on any op of the dispatch;
    and no ``double`` in ``kernels/csrc/*.cu*`` with comments stripped
    (``check_sources``), since the dispatch mode cannot see inside a
    launch.
  * ``kernel-inplace-alias`` — the four in-place scatters return their
    destination's storage; on the card the peak allocation during the
    dispatch rises by less than one destination.
  * ``kernel-single-dispatch`` — one fused GET or SCAN batch adds exactly
    1 to its own ``LAUNCHES`` counter and 0 to every other (on the card:
    the CPU runs the plain versions, which launch nothing).
  * ``kernel-host-readback`` (the reference's ``kernel-no-callback``) —
    no more read-backs a dispatch than the count pinned in the registry,
    each with its reason (on the card).
  * ``kernel-smem-budget`` (the reference's ``kernel-vmem-budget``) —
    each launch's dynamic shared memory at most the device's
    ``shared_memory_per_block_optin`` (the H100's 232,448 bytes on the
    CPU); on the card the fused read's Python mirror
    (``fused_read.smem_bytes``) must also equal its launcher's figure.

CLI::

    python -m repro_torch.analysis.kernel_check [--device cuda|cpu] [--json OUT]
"""
from __future__ import annotations

import dataclasses
import json
import re
import sys
import warnings
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .lint import REPO_ROOT, Finding

#: shared memory a block of an H100 may opt in to (the device's
#: ``shared_memory_per_block_optin``), the budget where no card is asked
H100_SMEM_OPTIN = 232448
CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
WIDE_DTYPES = (torch.float64, torch.complex128)
_SYNC_WARNING = "synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One entry point of ``kernels/ops.py`` and what it must hold."""
    name: str               # e.g. "ops.log_replay_scatter"
    path: str               # repo-relative wrapper source (finding anchor)
    counter: str            # its kernel's ``build.LAUNCHES`` key
    build: Callable         # (device) -> (fn, args, kwargs, dst or None)
    smem: Callable          # () -> [(shape label, dynamic smem bytes)],
                            # the default geometry's figure first
    in_place: bool = False  # returns its destination, allocates no copy
    fused: bool = False     # one launch a batch
    readbacks: int = 0      # pinned device -> host read-backs a dispatch
    readback_reason: str = ""


@dataclasses.dataclass
class DispatchRecord:
    """What one run of an entry point showed."""
    device: str                     # "cuda" or "cpu"
    counter: str                    # the entry's own LAUNCHES key
    ops: list                       # [(aten op, [dtype names])]
    launches: dict                  # LAUNCHES key -> increase
    aliased: bool | None = None     # result is the destination's storage
    dst_bytes: int = 0              # bytes of one destination tensor
    readbacks: int | None = None    # on the card
    alloc_rise: int | None = None   # on the card: peak - start, bytes
    smem: list = dataclasses.field(default_factory=list)
    smem_launcher: list = dataclasses.field(default_factory=list)


class _DtypeRecorder(TorchDispatchMode):
    """Records every aten op of a dispatch with its tensors' dtypes."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = tree_flatten((args, kwargs or {}, out))[0]
        self.ops.append((str(func), sorted({str(t.dtype) for t in leaves
                                            if isinstance(t, torch.Tensor)})))
        return out


# ------------------------------------------------------------- the check
def check_record(name: str, path: str, record: DispatchRecord, *,
                 in_place: bool = False, fused: bool = False,
                 smem_limit: int = H100_SMEM_OPTIN,
                 readbacks: int = 0) -> list[Finding]:
    """Audit one recorded dispatch; a pure function of the record."""
    findings: list[Finding] = []
    wide = {str(d) for d in WIDE_DTYPES}
    for op, dtypes in record.ops:
        hit = wide.intersection(dtypes)
        if hit:
            findings.append(Finding(
                "kernel-no-f64", path, 1,
                f"{name}: {sorted(hit)[0]} value flows through '{op}' — "
                f"the store's device lanes are 32-bit"))
    if in_place:
        if not record.aliased:
            findings.append(Finding(
                "kernel-inplace-alias", path, 1,
                f"{name}: the in-place scatter returned other storage than "
                f"its destination — every sync would copy the image"))
        if record.alloc_rise is not None \
                and record.alloc_rise >= record.dst_bytes:
            findings.append(Finding(
                "kernel-inplace-alias", path, 1,
                f"{name}: the peak allocation rose by {record.alloc_rise} B "
                f"during the dispatch, a destination holds "
                f"{record.dst_bytes} B — the scatter materialized a copy"))
    if fused and record.device == "cuda":
        own = record.launches.get(record.counter, 0)
        others = {k: v for k, v in record.launches.items()
                  if k != record.counter and v}
        if own != 1 or others:
            findings.append(Finding(
                "kernel-single-dispatch", path, 1,
                f"{name}: one fused batch made {own} '{record.counter}' "
                f"launch(es) and {others or 'no'} other(s), expected "
                f"exactly 1 — the single-launch contract is broken"))
    if record.readbacks is not None and record.readbacks > readbacks:
        findings.append(Finding(
            "kernel-host-readback", path, 1,
            f"{name}: {record.readbacks} device -> host read-back(s) in "
            f"one dispatch, {readbacks} pinned — each stalls the host on "
            f"the device mid-batch"))
    for label, nbytes in record.smem:
        if nbytes > smem_limit:
            findings.append(Finding(
                "kernel-smem-budget", path, 1,
                f"{name}: {nbytes} B of dynamic shared memory a block at "
                f"{label}, the device allows {smem_limit} B"))
    for label, mirror, launcher in record.smem_launcher:
        if mirror != launcher:
            findings.append(Finding(
                "kernel-smem-budget", path, 1,
                f"{name}: the Python mirror sizes {mirror} B of shared "
                f"memory at {label}, the launcher asks for {launcher} B"))
    return findings


def strip_comments(source: str) -> str:
    """C/C++ source with its comments blanked, line numbers kept."""
    out = re.sub(r"/\*.*?\*/", lambda m: re.sub(r"[^\n]", " ", m.group()),
                 source, flags=re.S)
    return re.sub(r"//[^\n]*", "", out)


def check_sources(csrc: Path = CSRC, root: Path = REPO_ROOT
                  ) -> list[Finding]:
    """``kernel-no-f64`` over the CUDA sources: no ``double`` in code."""
    findings = []
    for path in sorted(csrc.glob("*.cu*")):
        rel = str(path.relative_to(root)) if path.is_relative_to(root) \
            else str(path)
        text = strip_comments(path.read_text())
        for i, line in enumerate(text.splitlines(), start=1):
            if re.search(r"\bdouble\b", line):
                findings.append(Finding(
                    "kernel-no-f64", rel, i,
                    "double in a kernel source — the device lanes are "
                    "32-bit (and f64 runs at a fraction of f32's rate)"))
    return findings


# ------------------------------------------------------------ the record
def smem_limit(device) -> int:
    """The device's per-block opt-in shared memory; the H100's on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin)
    return H100_SMEM_OPTIN


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def run_entry(entry: KernelEntry, device) -> DispatchRecord:
    """Run ``entry`` once on ``device`` and record its dispatch."""
    from ..kernels import build
    device = torch.device(device)
    on_card = device.type == "cuda"
    fn, args, kwargs, dst = entry.build(device)
    mode = _DtypeRecorder()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    before = dict(build.LAUNCHES)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with mode:
                out = fn(*args, **kwargs)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(prev)
    launches = {k: build.LAUNCHES[k] - before.get(k, 0)
                for k in build.LAUNCHES}
    rec = DispatchRecord(device=device.type, counter=entry.counter,
                         ops=mode.ops, launches=launches,
                         smem=list(entry.smem()))
    if on_card:
        torch.cuda.synchronize(device)
        rec.alloc_rise = torch.cuda.max_memory_allocated(device) - base
        rec.readbacks = sum(_SYNC_WARNING in str(w.message) for w in caught)
    if dst is not None:
        dsts = dst if isinstance(dst, tuple) else (dst,)
        outs = out if isinstance(out, tuple) else (out,)
        rec.aliased = len(outs) == len(dsts) and all(
            _storage(o) == _storage(d) for o, d in zip(outs, dsts))
        rec.dst_bytes = min(d.numel() * d.element_size() for d in dsts)
    if on_card and entry.fused:
        from ..kernels import fused_read
        for label, cfg, C in _fused_shapes():
            rec.smem_launcher.append(
                (label, fused_read.smem_bytes(cfg, C),
                 fused_read.launcher_smem_bytes(cfg, C)))
    return rec


# ------------------------------------------------------ the entry points
def _fused_shapes() -> list:
    """(label, cfg, cache rows) of the fused read's shared memory: the
    default store, the serving page table's store, and the largest cache
    the launcher admits at the default geometry.  That last figure is
    ``MAX_SMEM`` by construction: it only holds the launcher's cap to the
    device's opt-in limit."""
    from ..core import HoneycombConfig
    from ..kernels import fused_read
    from ..serving.kv_cache import _store_config
    cfg = HoneycombConfig()
    page = _store_config()
    fixed = fused_read.smem_bytes(cfg, 0)
    c_max = (fused_read.MAX_SMEM - fixed) // 4
    return [("default HoneycombConfig", cfg, cfg.cache_slots),
            ("serving page table (key_words=4)", page, page.cache_slots),
            (f"largest admitted cache, C = {c_max}", cfg, c_max)]


def _largest_replay_words() -> int:
    """The widest log record the replay plan admits (at 4,096 entries)."""
    from ..kernels.delta_scatter import replay_plan
    ew = 1
    while True:
        try:
            replay_plan(4096, ew + 1)
        except ValueError:
            return ew
        ew += 1


def kernel_entries() -> list[KernelEntry]:
    """Every entry point of ``kernels/ops.py`` with small seeded inputs
    (the default geometry's widths; a few rows) and its shared-memory
    figures."""
    from ..core import HoneycombConfig, NodeImageLayout, StoreShard
    from ..core.keys import pack_keys
    from ..kernels import (delta_scatter, fused_read, key_search,
                           leaf_merge, moe_grouped, ops, paged_attention)

    cfg = HoneycombConfig()
    layout = NodeImageLayout.for_config(cfg)
    offs = layout.log_replay_offsets()
    IW, LW = layout.image_words, layout.log_entry_words
    KW, VW, N, L = cfg.key_words, cfg.val_words, cfg.node_cap, cfg.log_cap
    S, B, E = 256, 8, 4

    def words(rng, shape, device):
        return torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)).to(
                device, copy=True)

    def ints(rng, lo, hi, shape, device):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(device, copy=True)

    def rows_of(rng, device):
        return torch.from_numpy(rng.choice(S, E, replace=False).astype(
            np.int32)).to(device, copy=True)

    def delta(device):
        rng = np.random.default_rng(1)
        dst = words(rng, (S, KW), device)
        return (ops.snapshot_delta_scatter,
                (dst, rows_of(rng, device), words(rng, (E, KW), device)),
                {}, dst)

    def image(device):
        rng = np.random.default_rng(2)
        dst = words(rng, (S, IW), device)
        return (ops.snapshot_image_scatter,
                (dst, rows_of(rng, device), words(rng, (E, IW), device)),
                {}, dst)

    def multi(device):
        rng = np.random.default_rng(3)
        widths = (KW, 4, VW)
        dsts = tuple(words(rng, (S, w), device) for w in widths)
        upd = tuple(words(rng, (E, w), device) for w in widths)
        return (ops.snapshot_multi_scatter, (dsts, rows_of(rng, device), upd),
                {}, dsts)

    def log_replay(device):
        rng = np.random.default_rng(4)
        dst = words(rng, (S, IW), device)
        return (ops.log_replay_scatter,
                (dst, rows_of(rng, device), ints(rng, 0, L, (E,), device),
                 words(rng, (E, LW), device)), {"offs": offs}, dst)

    def snapshot(device):
        shard = StoreShard(cfg, device=device)
        for i in range(200):
            shard.put(b"k%05d" % i, b"v%05d" % i)
        return shard.export_snapshot()

    def packed(keys, device):
        lanes, lens = pack_keys(keys, KW)
        return (torch.from_numpy(lanes.view(np.int32)).to(device, copy=True),
                torch.from_numpy(lens).to(device, copy=True))

    def get(device):
        snap = snapshot(device)
        key, klen = packed([b"k%05d" % (7 * i) for i in range(B)], device)
        return ops.batched_get_fused, (snap, key, klen), {"cfg": cfg}, None

    def scan(device):
        snap = snapshot(device)
        lo = packed([b"k%05d" % (9 * i) for i in range(B)], device)
        hi = packed([b"k%05d" % (9 * i + 5) for i in range(B)], device)
        return (ops.batched_scan_fused, (snap, *lo, *hi), {"cfg": cfg},
                None)

    def search(device):
        rng = np.random.default_rng(5)
        return (ops.key_search,
                (words(rng, (B, KW), device),
                 ints(rng, 1, 4 * KW + 1, (B,), device),
                 words(rng, (B, N, KW), device),
                 ints(rng, 1, 4 * KW + 1, (B, N), device),
                 ints(rng, 0, 2, (B, N), device)), {}, None)

    def search_image(device):
        rng = np.random.default_rng(6)
        o = layout.offsets()
        rows = snapshot(device).image[:B].contiguous()
        return (ops.key_search_image,
                (words(rng, (B, KW), device),
                 ints(rng, 1, 4 * KW + 1, (B,), device), rows),
                {"keys_off": o["sc_keys"][0], "lens_off": o["sc_keylen"][0],
                 "count_off": o["n_shortcuts"][0],
                 "n_keys": cfg.n_shortcuts, "key_words": KW},
                None)

    def merge(device):
        rng = np.random.default_rng(7)
        return (ops.leaf_merge,
                (ints(rng, 0, N + 1, (B,), device),
                 ints(rng, 0, L + 1, (B,), device),
                 ints(rng, -1, N, (B, L), device),
                 ints(rng, 0, N + L, (B, L), device)),
                {"node_cap": N, "log_cap": L}, None)

    H, KVH, D, P, NP, PPS = 4, 2, 64, 16, 12, 3

    def paged(device):
        g = torch.Generator().manual_seed(8)
        q = torch.randn(B, H, D, generator=g)
        k = torch.randn(NP, P, KVH, D, generator=g)
        v = torch.randn(NP, P, KVH, D, generator=g)
        bt = torch.randint(0, NP, (B, PPS), generator=g, dtype=torch.int32)
        sl = torch.randint(1, P * PPS + 1, (B,), generator=g,
                           dtype=torch.int32)
        return (ops.paged_attention,
                tuple(t.to(device) for t in (q, k, v, bt, sl)), {}, None)

    # bf16 at whole tiles, so the card takes the wgmma products
    ME, MK, MT, Md, Mf = 4, 2, 6, 256, 128

    def grouped(device):
        g = torch.Generator().manual_seed(9)
        x = torch.randn(MT, Md, generator=g).to(torch.bfloat16)
        ids = torch.stack([torch.randperm(ME, generator=g)[:MK]
                           for _ in range(MT)])
        gates = torch.rand(MT, MK, generator=g)
        w = [(torch.randn(ME, a, b, generator=g) * 0.05).to(torch.bfloat16)
             for a, b in ((Md, Mf), (Md, Mf), (Mf, Md))]
        return (ops.moe_grouped, tuple(t.to(device) for t in (
            x, gates / gates.sum(-1, keepdim=True), ids, *w)), {}, None)

    # ---- shared-memory figures (bytes of dynamic shared memory a block)
    def no_smem():
        # the row copy asks for none: its field table is static
        # (csrc/scatter_rows.cuh), whatever the shapes
        return [("any shape (static field table only)", 0)]

    def fused_smem():
        return [(label, fused_read.smem_bytes(c, C))
                for label, c, C in _fused_shapes()]

    def replay_smem():
        ew = _largest_replay_words()
        return [(f"default geometry, D = {d}", delta_scatter.replay_plan(
                    d, LW).smem_bytes) for d in (E, 4096)] \
            + [(f"largest admitted record, EW = {ew}",
                delta_scatter.replay_plan(4096, ew).smem_bytes)]

    def widest(plan, widths):
        # a block of 4,096 keys fills a warp's buffer at every key width
        smem, kw = max((plan(4096, kw).smem_bytes, kw) for kw in widths)
        return (f"largest admitted, 4096 keys of {kw} lanes", smem)

    def image_smem():
        shapes = [("default sorted block", N, KW),
                  ("default shortcut block", cfg.n_shortcuts, KW)]
        return [(label, key_search.image_plan(n, kw).smem_bytes)
                for label, n, kw in shapes] \
            + [widest(key_search.image_plan, range(1, 1023))]

    def block_smem():
        # keys above ~1,020 lanes go in passes of lanes: every wider key
        # stages the same words as one of 1,100
        return [("default sorted block",
                 key_search.block_plan(N, KW).smem_bytes),
                widest(key_search.block_plan, range(1, 1101))]

    def merge_smem():
        top = leaf_merge.MAX_SHARED_WORDS // 2
        shapes = [("default leaf", N, L),
                  (f"largest admitted log, 0 + {top}", 0, top)]
        return [(label, leaf_merge.merge_plan(n, x).smem_bytes)
                for label, n, x in shapes]

    def paged_smem():
        def elem(dt):
            return 2 if dt == torch.bfloat16 else 4
        out = [("dispatch", paged_attention.span_plan(
            B, H, KVH, PPS, P, D, torch.float32).smem)]
        # every head group and head dim the wrapper takes, over a sequence
        # long enough for the plan's third stage
        for dt in (torch.float32, torch.bfloat16):
            smem, G, Dh = max(
                (paged_attention.span_plan(1, G, 1, 64, 256, Dh, dt).smem,
                 G, Dh)
                for G in range(1, paged_attention.MAX_GROUP + 1)
                for Dh in range(8, paged_attention.MAX_HEAD_DIM + 1, 8))
            out.append((f"largest admitted, G = {G}, D = {Dh}, "
                        f"{elem(dt) * 8}-bit pools", smem))
        return out

    def grouped_smem():
        # the products' ring of stages; the dispatch's ids, one byte a
        # pair, beside its static per-warp counts
        return [("products, any shape", moe_grouped.WGMMA_SMEM),
                (f"dispatch, {MT * MK} pairs",
                 moe_grouped.dispatch_smem_bytes(MT * MK)),
                (f"largest admitted dispatch, {moe_grouped.MAX_PAIRS} pairs",
                 moe_grouped.dispatch_smem_bytes(moe_grouped.MAX_PAIRS))]

    k = "src/repro_torch/kernels"
    check_rows = ("kernels/ref.py:check_rows reads the rows' minimum and "
                  "maximum back before the scatter writes (raise before "
                  "write; a device-side check is deferred work)")
    return [
        KernelEntry("ops.snapshot_delta_scatter", f"{k}/delta_scatter.py",
                    "row_scatter", delta, no_smem, in_place=True,
                    readbacks=1, readback_reason=check_rows),
        KernelEntry("ops.snapshot_image_scatter", f"{k}/delta_scatter.py",
                    "row_scatter", image, no_smem, in_place=True,
                    readbacks=1, readback_reason=check_rows),
        KernelEntry("ops.snapshot_multi_scatter", f"{k}/delta_scatter.py",
                    "multi_scatter", multi, no_smem, in_place=True,
                    readbacks=1, readback_reason=check_rows),
        KernelEntry("ops.log_replay_scatter", f"{k}/delta_scatter.py",
                    "log_replay", log_replay, replay_smem, in_place=True,
                    readbacks=1,
                    readback_reason="the kernel's verdict flag on the rows "
                                    "and slots, read once after the launch "
                                    "(kernels/delta_scatter.py)"),
        KernelEntry("ops.batched_get_fused", f"{k}/fused_read.py",
                    "fused_get", get, fused_smem, fused=True),
        KernelEntry("ops.batched_scan_fused", f"{k}/fused_read.py",
                    "fused_scan", scan, fused_smem, fused=True),
        KernelEntry("ops.key_search", f"{k}/key_search.py", "key_search",
                    search, block_smem),
        KernelEntry("ops.key_search_image", f"{k}/key_search.py",
                    "key_search_image", search_image, image_smem),
        KernelEntry("ops.leaf_merge", f"{k}/leaf_merge.py", "leaf_merge",
                    merge, merge_smem),
        KernelEntry("ops.paged_attention", f"{k}/paged_attention.py",
                    "paged_attention", paged, paged_smem),
        KernelEntry("ops.moe_grouped", f"{k}/moe_grouped.py",
                    "moe_grouped", grouped, grouped_smem),
    ]


def run_kernel_checks(device="cuda") -> tuple[list[Finding], list]:
    """Run and audit every entry point on ``device`` ("cuda" raises
    without a card), plus the source scan.  Returns (findings,
    [(entry, record)])."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the kernel check on cuda needs a CUDA device; "
                           "pass --device cpu to audit the plain versions")
    limit = smem_limit(device)
    findings = check_sources()
    runs = []
    for entry in kernel_entries():
        rec = run_entry(entry, device)
        runs.append((entry, rec))
        findings.extend(check_record(
            entry.name, entry.path, rec, in_place=entry.in_place,
            fused=entry.fused, smem_limit=limit, readbacks=entry.readbacks))
    return findings, runs


def summary(runs, findings, device) -> list[dict]:
    """One line per entry point: launches a dispatch, read-backs, the
    shared memory at the default geometry (the record's first figure;
    the largest admitted shapes are checked, not shown) against the
    limit, the allocation rise and the findings anchored at its source."""
    limit = smem_limit(device)
    out = []
    for entry, rec in runs:
        out.append({
            "name": entry.name, "counter": entry.counter,
            "launches": rec.launches.get(entry.counter, 0),
            "other_launches": sum(v for k, v in rec.launches.items()
                                  if k != entry.counter),
            "readbacks": rec.readbacks, "readbacks_pinned": entry.readbacks,
            "smem_bytes": rec.smem[0][1], "smem_limit": limit,
            "alloc_rise": rec.alloc_rise,
            "aliased": rec.aliased, "dst_bytes": rec.dst_bytes,
            "findings": [str(f) for f in findings
                         if f.message.startswith(entry.name + ":")]})
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.kernel_check")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", help="write findings as JSON to this path")
    args = ap.parse_args(argv)
    findings, runs = run_kernel_checks(args.device)
    for f in findings:
        print(f)
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"findings": [f.to_json() for f in findings],
             "entries": summary(runs, findings, args.device)},
            indent=1) + "\n")
    print(f"kernel_check: {len(runs)} entry points run on {args.device}, "
          f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
