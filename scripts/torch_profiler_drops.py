"""How often torch.profiler loses device activities at the start of a
short trace, with and without ``chip_smoke.TRACE_GUARD_S`` of idle time
traced before and after the measured window.

The profiler keeps only the device activities inside its capture range
and places them on the host's clock.  For as long as ``--seconds`` asks,
the script loads the card with bf16 products and then, in turn, traces
16 and 64 calls (a fill of a 256 MiB flush tensor, then two element-wise
kernels each) with no guard and with the guard.  A trace is short when it
holds fewer fills or kernels than it launched.  Per guard it prints the
traces taken, the short ones, and the earliest start of a kernel minus
that of its launch on the host, which is below 0 when the placement is
shifted.  It needs a card.

    python scripts/torch_profiler_drops.py [--seconds 120]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import TRACE_GUARD_S, device_events_raw  # noqa: E402


def trace(flush, y, calls: int, guard: float) -> dict:
    """One trace of ``calls`` calls: counts of the device activities by
    kind and the earliest kernel start minus its launch, in us."""
    def run():
        for r in range(calls):
            flush.fill_(r)
            y.mul_(1.0001)
            y.add_(0.5)
    evs = device_events_raw(run, guard)
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.name != "smoke_window"]
    launches = {e.id: e.time_range.start for e in evs
                if e.device_type == DeviceType.CPU
                and "LaunchKernel" in e.name}
    lags = [e.time_range.start - launches[e.id] for e in kernels
            if e.id in launches]
    return {"kernels": len(kernels),
            "short": len(kernels) < 3 * calls,
            "lag_min_us": min(lags) if lags else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no card: this script measures the profiler on a card",
              file=sys.stderr)
        return 1
    dev = "cuda"
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    y = torch.randn(256, 1024, device=dev)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    out = {g: {"traces": 0, "short": 0, "lag_min_us": None}
           for g in (0.0, TRACE_GUARD_S)}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
        for g, row in out.items():
            for calls in (16, 64):
                r = trace(flush, y, calls, g)
                row["traces"] += 1
                row["short"] += r["short"]
                lags = [x for x in (row["lag_min_us"], r["lag_min_us"])
                        if x is not None]
                row["lag_min_us"] = min(lags) if lags else None
    for g, row in out.items():
        print(json.dumps({"guard_s": g, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
