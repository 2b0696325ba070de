#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Honeycomb once on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, loads a
store of 2^18 8-byte keys with 16-byte values at the paper's node geometry
(the default ``HoneycombConfig``), serves GET batches and 8-key SCAN
batches through the fused read kernel, applies about a thousand updates,
deletes and inserts so that the next read takes a delta sync through the
row-scatter kernel, and reads again.  Every answer is checked against a
dict model with floor-start SCAN semantics and against the store's host
tree, and each kernel's launches during that run are counted.  A
torch.profiler trace of a few read batches gives the device's busy share.
Then each kernel is held against its plain PyTorch version on the card at
the shapes the run gave it.  Each kernel's device time comes from a
torch.profiler trace with the L2 cache flushed before every launch; the
time per call through its Python wrapper and the plain version's time
come from CUDA events.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py [--keys-log2 18] [--batches 32] [--seed 0]

It prints the timings, the card's name and power limit, a
``{"kernels": [...]}`` line and last ``{"ok": true, "device": {...}}``.
It exits non-zero, printing no result, when no CUDA device is present or
when any check fails.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
BATCH = 256                     # requests per device read batch
SCAN_ITEMS = 8                  # YCSB E scan length (benchmarks/ycsb.py:54)
ROTATE = 16                     # distinct batches cycled while timing


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def value(i: int, gen: int) -> bytes:
    """The 16-byte value of key i at write generation gen."""
    return struct.pack(">QQ", i, gen)


def model_scan(keys: list[bytes], model: dict, lo: bytes, hi: bytes):
    """SCAN(lo, hi) with floor-start semantics (paper Section 3.3): the
    largest key <= lo, then every key in (lo, hi], in order."""
    j = bisect.bisect_right(keys, lo)
    end = bisect.bisect_right(keys, hi)
    return [(k, model[k]) for k in keys[max(j - 1, 0):end]]


def cuda_ms(fns: list, reps: int) -> float:
    """Mean time of one call, cycling through ``fns``, by CUDA events
    after a warm-up pass.  Back-to-back calls: where the host's work per
    call outlasts the device's, this is the host's time per call."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fns[r % len(fns)]()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_events(fn):
    """Run ``fn`` under torch.profiler.  Returns the (name, microseconds)
    of every device activity (kernel, copy, set) it caused, and the
    microseconds of the whole window on the host's clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke_window"):
            fn()
            torch.cuda.synchronize()
    evs = prof.events()
    window = next(e.time_range.elapsed_us() for e in evs
                  if e.name == "smoke_window")
    # the window's own annotation is mirrored onto the device's timeline
    return [(e.name, e.time_range.elapsed_us()) for e in evs
            if e.device_type == DeviceType.CUDA
            and e.name != "smoke_window"], window


def print_activities(events, what: str, top: int = 6) -> None:
    """The device activities of a trace that took the most time, by name:
    count, total and mean microseconds."""
    by = {}
    for name, t in events:
        n, tot = by.get(name, (0, 0.0))
        by[name] = (n + 1, tot + t)
    for name, (n, tot) in sorted(by.items(), key=lambda x: -x[1][1])[:top]:
        print(f"  {what}: {n} x {name[:90]!r}, {tot:.1f} us in all, "
              f"{tot / n:.2f} us each")


def device_ms(fns: list, reps: int, match: str, flush: torch.Tensor) -> float:
    """Mean device time of the kernel whose name holds ``match``, one
    launch per call, cycling through ``fns``, from the profiler's trace.
    ``flush`` (larger than the 50 MB L2) is overwritten before each call,
    because the main path's reads find the image cold.  The host's work
    around the launch is left out."""
    for fn in fns:
        fn()

    def run():
        for r in range(reps):
            flush.fill_(r)
            fns[r % len(fns)]()
    us = [t for name, t in device_events(run)[0] if match in name]
    check(len(us) == reps, f"the profiler traced {len(us)} of {reps} "
                           f"launches of {match}")
    return sum(us) / reps / 1e3


def max_abs_err(want, got) -> int:
    """Largest absolute difference over every field of two results."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(want, got))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys-log2", type=int, default=18)
    ap.add_argument("--batches", type=int, default=32,
                    help="GET batches and SCAN batches per read phase")
    ap.add_argument("--writes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import HoneycombConfig, HoneycombStore
    from repro_torch.core.config import bucket_pow2
    from repro_torch.core.keys import int_key, pack_keys
    from repro_torch.kernels import build, delta_scatter, fused_read, ops, ref

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card {card}")

    # ---- build every kernel of the path, one nvcc per source -------------
    t0 = time.perf_counter()
    reports = build.build(["fused_read", "row_scatter"])
    print(f"build: {time.perf_counter() - t0:.3f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- load the store (host tree only; no device work yet) -------------
    cfg = HoneycombConfig()
    rng = np.random.default_rng(args.seed)
    n = 1 << args.keys_log2
    store = HoneycombStore(cfg, device="cuda")
    model: dict[bytes, bytes] = {}
    t0 = time.perf_counter()
    for i in rng.permutation(n):
        k, v = int_key(int(i)), value(int(i), 0)
        store.put(k, v)
        model[k] = v
    load_s = time.perf_counter() - t0
    heap = store.tree.heap
    print(f"load: {n} puts in {load_s:.3f} s ({n / load_s:.0f} puts/s); "
          f"height {store.tree.height}, {heap.live_slots} live node slots, "
          f"heap capacity {heap.capacity} rows")

    def read_phase():
        """GET and SCAN batches through the store's public entry points;
        returns them with their answers and host-clock latencies."""
        gets, scans, lat = [], [], {"get": [], "scan": []}
        for _ in range(args.batches):
            keys = [int_key(int(x)) for x in
                    rng.integers(0, n + n // 4, BATCH)]      # ~20% misses
            t = time.perf_counter()
            gets.append((keys, store.get_batch(keys)))
            lat["get"].append(time.perf_counter() - t)
            ranges = [(int_key(int(x)), int_key(int(x) + SCAN_ITEMS - 1))
                      for x in rng.integers(0, n, BATCH)]
            t = time.perf_counter()
            scans.append((ranges, store.scan_batch(ranges)))
            lat["scan"].append(time.perf_counter() - t)
        return gets, scans, lat

    def check_answers(gets, scans, phase):
        """Every answer equals the dict model and the host tree."""
        keys_sorted = sorted(model)
        for keys, answers in gets:
            for k, a in zip(keys, answers):
                check(a == model.get(k), f"{phase} GET {k!r}: {a!r}")
                check(a == store.tree.get(k), f"{phase} GET {k!r} vs tree")
        for ranges, answers in scans:
            for (lo, hi), a in zip(ranges, answers):
                check(a == model_scan(keys_sorted, model, lo, hi),
                      f"{phase} SCAN {lo!r}..{hi!r}")
                check(a == store.tree.scan(lo, hi),
                      f"{phase} SCAN {lo!r}..{hi!r} vs tree")

    # ---- the main path, every launch count set to 0 just before it -------
    build.reset_launches()
    ops.reset_read_dispatches()
    t0 = time.perf_counter()
    store.export_snapshot()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    gets1, scans1, lat1 = read_phase()
    check_answers(gets1, scans1, "before the writes")
    # updates, deletes and inserts; a 9-byte key sorts right after its
    # 8-byte prefix, so the inserts spread over the whole tree
    writes = []
    for j, op in enumerate(rng.choice(3, args.writes, p=[0.6, 0.2, 0.2])):
        i = int(rng.integers(0, n))
        writes.append((int(op), i, j + 1))
    t0 = time.perf_counter()
    for op, i, gen in writes:
        k = int_key(i)
        if op == 0:
            store.update(k, value(i, gen))
        elif op == 1:
            store.delete(k)
        else:
            store.put(k + b"\x01", value(i, gen))
    write_s = time.perf_counter() - t0
    for op, i, gen in writes:
        k = int_key(i)
        if op == 0:
            model[k] = value(i, gen)
        elif op == 1:
            model.pop(k, None)
        else:
            model[k + b"\x01"] = value(i, gen)
    t0 = time.perf_counter()
    store.export_snapshot()
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t0
    gets2, scans2, lat2 = read_phase()
    launches = dict(build.LAUNCHES)
    dispatches = ops.read_dispatch_stats()

    # ---- answers, syncs and launches --------------------------------------
    sync = store.sync_stats
    check(sync.full_syncs == 1 and sync.delta_syncs >= 1, f"syncs {sync}")
    n_get, n_scan = len(gets1) + len(gets2), len(scans1) + len(scans2)
    check(launches["fused_get"] == n_get, f"GET launches {launches}")
    check(launches["fused_scan"] == n_scan, f"SCAN launches {launches}")
    check(launches["row_scatter"] == sync.delta_syncs,
          f"scatter launches {launches} vs {sync.delta_syncs} delta syncs")
    check(dispatches["get_fused"]["batches"] == n_get
          and dispatches["scan_fused"]["batches"] == n_scan,
          f"read dispatches {dispatches}")
    check_answers(gets2, scans2, "after the writes")
    print(f"checked {n_get * BATCH} GETs and {n_scan * BATCH} SCANs, "
          f"before and after the delta sync, against the model and the "
          f"host tree")
    print(f"main path: full export {full_s * 1e3:.3f} ms, "
          f"{args.writes} host writes {write_s * 1e3:.3f} ms, delta export "
          f"{delta_s * 1e3:.3f} ms ({sync.delta_rows} dirty rows)")
    for op in ("get", "scan"):
        xs = sorted(lat1[op] + lat2[op])
        med = statistics.median(xs)
        print(f"  {op} batch of {BATCH} (host clock, answers decoded): "
              f"median {med * 1e3:.3f} ms, max {xs[-1] * 1e3:.3f} ms, "
              f"{BATCH / med:.0f} requests/s")
    print(f"  launches {launches}")
    print(f"  {sync}")
    print(f"  {store.cache_stats}")
    print(f"  truncated SCANs answered by the host tree: "
          f"{store.scan_fallbacks}")

    # ---- the device's busy share over read batches ------------------------
    # after the main path's counts were read; the profiler's own host cost
    # lengthens the window, so this share is a lower bound
    def read_batches():
        for (keys, _), (ranges, _) in zip(gets2[:8], scans2[:8]):
            store.get_batch(keys)
            store.scan_batch(ranges)
    read_batches()
    events, window_us = device_events(read_batches)
    busy_us = sum(t for _, t in events)
    print(f"device busy {busy_us / window_us:.4f} of the window over 8 GET "
          f"and 8 SCAN batches ({busy_us:.1f} of {window_us:.1f} us, "
          f"torch.profiler)")
    print_activities(events, "read batches")

    # ---- each kernel against its plain version, at the path's shapes -----
    snap = store.export_snapshot()          # clean: the active snapshot
    S, IW = snap.image.shape
    C = snap.cache_lids.shape[0]
    print(f"snapshot: image {S} x {IW} words ({S * IW * 4} B), cache "
          f"{C} rows, {int((snap.cache_lids >= 0).sum())} cached LIDs")
    flush = torch.empty(128 << 20, dtype=torch.int8, device=dev)

    def packed(keys):
        lanes, lens = pack_keys(keys, cfg.key_words)
        return (torch.from_numpy(lanes.view(np.int32)).to(dev),
                torch.from_numpy(lens).to(dev))

    inputs = {
        "fused_get": [packed(k) for k, _ in gets2[-ROTATE:]],
        "fused_scan": [packed([r[0] for r in rs]) + packed([r[1] for r in rs])
                       for rs, _ in scans2[-ROTATE:]],
    }
    kernels = []
    for name, kfn, pfn, line in (
            ("fused_get", fused_read.batched_get_fused,
             ref.batched_get_fused_ref, "src/repro/kernels/fused_read.py:302"),
            ("fused_scan", fused_read.batched_scan_fused,
             ref.batched_scan_fused_ref,
             "src/repro/kernels/fused_read.py:256")):
        xs = inputs[name]
        err = 0
        for lb in (0.0, 0.25):
            for x in xs[:4]:
                want, wm = pfn(snap, *x, cfg=cfg, lb_fraction=lb)
                got, gm = kfn(snap, *x, cfg=cfg, lb_fraction=lb)
                e = max_abs_err(list(want) + [wm], list(got) + [gm])
                check(e == 0 and all(a.dtype == b.dtype for a, b in
                                     zip(want, got)),
                      f"{name} lb_fraction={lb}: kernel differs from plain "
                      f"(max abs err {e})")
                err = max(err, e)
        # the bound: distinct image rows a batch reads, plus its inputs and
        # outputs, over the memory rate
        rows_read, loads = [], []
        for x in xs:
            touched = torch.zeros(S + C, dtype=torch.int32, device=dev)
            per_req = torch.zeros(BATCH, dtype=torch.int32, device=dev)
            kfn(snap, *x, cfg=cfg, touched=touched, loads=per_req)
            rows_read.append(int(touched.sum()))
            loads.append(per_req)
        loads = torch.cat(loads).float()
        kw, vw, m = cfg.key_words, cfg.val_words, cfg.max_scan_items
        io = (BATCH * (kw + 1) * 4 * (1 if name == "fused_get" else 2)
              + BATCH * 4 * ((vw + 2) if name == "fused_get"
                             else (2 + m * (kw + vw + 2))))
        bound_ms = (statistics.mean(rows_read) * IW * 4 + io) \
            / HBM_BYTES_PER_S * 1e3
        calls = [lambda x=x: kfn(snap, *x, cfg=cfg) for x in xs]
        plain = [lambda x=x: pfn(snap, *x, cfg=cfg) for x in xs]
        ms = device_ms(calls, 64, "fused_read_kernel", flush)
        wrapper_ms = cuda_ms(calls, 200)
        plain_ms = cuda_ms(plain, 16)
        print(f"{name}: equals its plain version exactly (tolerance 0) at "
              f"lb_fraction 0.0 and 0.25; kernel {ms:.4f} ms device time per "
              f"batch of {BATCH} (L2 flushed), {wrapper_ms:.4f} ms per call "
              f"through the wrapper back to back (plain {plain_ms:.4f} ms), "
              f"bound {bound_ms:.6f} ms from "
              f"{statistics.mean(rows_read):.1f} distinct rows per batch; "
              f"dependent row reads per request mean "
              f"{float(loads.mean()):.3f}, max {int(loads.max())}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_read.cu",
            "replaces": line, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None})

    # the scatter at the delta's shape: distinct dirty rows padded with
    # repeats of the last one, as the store pads them
    d = sync.delta_rows // sync.delta_syncs
    D = bucket_pow2(d)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    cases = []
    for _ in range(8):          # 8 distinct updates
        rows = torch.randperm(S, generator=gen)[:d].to(torch.int32)
        upd = torch.randint(-2 ** 31, 2 ** 31 - 1, (d, IW), generator=gen,
                            dtype=torch.int32)
        rows = torch.cat([rows, rows[-1:].expand(D - d)]).to(dev)
        upd = torch.cat([upd, upd[-1:].expand(D - d, IW)]).to(dev)
        cases.append((rows, upd, rows.long()))
    work, plain_img, lib_img = (snap.image.clone() for _ in range(3))
    err = 0
    for rows, upd, rows_long in cases[:2]:
        want = ref.snapshot_image_scatter_ref(plain_img, rows, upd)
        got = delta_scatter.snapshot_image_scatter(work, rows, upd)
        lib_img.index_copy_(0, rows_long, upd)
        e = max_abs_err([want, lib_img], [got, got])
        check(e == 0, f"row_scatter differs from plain (max abs err {e})")
        err = max(err, e)
    calls = [lambda c=c: delta_scatter.snapshot_image_scatter(
        work, c[0], c[1]) for c in cases]
    ms = device_ms(calls, 64, "row_scatter_kernel", flush)
    wrapper_ms = cuda_ms(calls, 200)
    plain_ms = cuda_ms([lambda c=c: ref.snapshot_image_scatter_ref(
        work, c[0], c[1]) for c in cases], 50)
    library_ms = device_ms([lambda c=c: lib_img.index_copy_(0, c[2], c[1])
                            for c in cases], 64, "index_copy", flush)

    def clones():
        for _ in range(8):
            snap.image.clone()
    clones()
    events = device_events(clones)[0]
    print_activities(events, "8 image clones")
    clone_ms = sum(t for _, t in events) / 8 / 1e3
    clone_event_ms = cuda_ms([snap.image.clone], 8)
    bound_ms = (D * IW * 4 + D * 4 + d * IW * 4) / HBM_BYTES_PER_S * 1e3
    print(f"row_scatter: equals its plain version and index_copy_ exactly "
          f"(tolerance 0); kernel {ms:.4f} ms device time for {D} rows ({d} "
          f"distinct) of {IW} words (L2 flushed), {wrapper_ms:.4f} ms per "
          f"call through the wrapper back to back (plain {plain_ms:.4f} ms, "
          f"index_copy_ {library_ms:.4f} ms device time), bound "
          f"{bound_ms:.6f} ms; the per-delta image clone ({S * IW * 4} B "
          f"each way) takes {clone_ms:.4f} ms device time, {clone_event_ms:.4f} "
          f"ms per clone back to back by CUDA events")
    kernels.append({
        "name": "row_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_scatter.cu",
        "replaces": "src/repro/kernels/delta_scatter.py:54",
        "launches": launches["row_scatter"], "max_abs_err": err, "ms": ms,
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms})

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
