"""Run one cell of BENCHMARK.json once, on the machine it is started on.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last the ``checks``
(each number compared beside its limit), which also close standard
error.  Exits non-zero with no result where the card is missing, where
the run fails, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
TOP = 10                     # entries of each breakdown list


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or its package."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _breakdown(trace) -> dict:
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"device_ops": [[name, us / 1e6] for name, (_, us) in ops],
            "idle_gaps": [[what, us / 1e6]
                          for what, us in trace.idle_gaps[:TOP]]}


def main(argv=None) -> int:
    args = _args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  the program under test, beside bench/
    import torch

    from . import harness
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    loop, params = harness.set_up(cell, args.seed)
    run = harness.measure(loop, cell, args.seconds, bool(args.trace))
    setup_s = run.t0 - T_START
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": torch.cuda.max_memory_allocated(0)}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_us / 1e6
        device["window_s"] = run.trace.window_us / 1e6
    loop.engine = None                  # the program's state goes first
    gc.collect()
    torch.cuda.empty_cache()
    ok, checks, sample, gaps = harness.judge(cell, run, params, args.seed)

    if args.trace:
        values = {m["name"]: harness.metric_reader(m["name"])(run)
                  for m in cell.per_layer}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        values = harness.end_to_end(run, setup_s)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    metrics = {name: {"value": values[name], "unit": unit}
               for name, unit in units.items()
               if values.get(name) is not None}
    w = harness.stats.window(run.records, run.t0, run.t1)
    attempted = sum(1 for r in run.records if r.submit_t <= run.t1
                    and (r.done_t is None or r.done_t > run.t0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 4
    result = {"correct": ok, "attempted": attempted,
              "failed": checks["failed_requests"]["value"],
              "metrics": metrics, "device": device}
    if run.trace is not None:
        result["breakdown"] = _breakdown(run.trace)
    result["checks"] = checks
    widest = max((float(g.max()) for g in gaps), default=None)
    print(f"{cell.name} seed {args.seed}: {len(w.ttft_s)} first tokens, "
          f"{len(w.finished)} requests finished in {run.t1 - run.t0:.3f} s;"
          f" {len(run.steps)} steps; set-up {setup_s:.3f} s; checked "
          f"{len(sample)} requests, {sum(len(g) for g in gaps)} served "
          f"tokens, widest gap {widest} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"({c['pass']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
