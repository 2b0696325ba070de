"""Readings that a cell's correctness limit is set from (card only).

    python3 -m bench.calibrate --workload <name> --seeds 1 2 3 ... \
        --seconds <s> [--control] [--fault NAME] [--out FILE]

For each seed, in one process: the cell's weights and traffic from the
seed, the closed loop at the cell's own load for ``--seconds``, and the
check (``harness.judge``: the sample of the finished requests run through
the reference, and ``check.verdict`` on its numbers).  It prints, per
seed, the program's gaps (the reference's best logit less the served
token's) and its verdict.  With ``--fault NAME`` the loop runs with that
fault of ``bench/faults.py`` planted underneath it, and the verdict is
the faulted program's.  With ``--control`` it also reads the control's
gaps, the reference computed in float8 in the program's place (the gap
of the token it puts first at each of the same positions), and gives
their mean to ``check.verdict``.  The limit lies above the largest
program reading of a dozen seeds or more and below the smallest control
reading (PERF.md gives both and the limit).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from . import faults
from .run import ROOT


def _summary(gaps) -> dict:
    import numpy as np
    g = np.concatenate(gaps) if gaps else np.zeros(0)
    return {"widest": float(g.max()) if g.size else None,
            "mean": float(g.mean()) if g.size else None,
            "share_nonzero": float((g > 0).mean()) if g.size else None,
            "tokens": int(g.size)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.ALL))
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from . import check, harness, stats
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload, ROOT)
    arch = cell.config["arch"]
    planted = faults.ALL[args.fault] if args.fault else contextlib.nullcontext
    for seed in args.seeds:
        t = time.perf_counter()
        with planted():
            loop, params = harness.set_up(cell, seed)
            run = harness.measure(loop, cell, args.seconds, False)
        loop.engine = None
        gc.collect()
        torch.cuda.empty_cache()
        ok, checks, sample, gaps = harness.judge(cell, run, params, seed)
        w = stats.window(run.records, run.t0, run.t1)
        rec = {"workload": cell.name, "seed": seed, "fault": args.fault,
               "finished": len(w.finished), "sampled": len(sample),
               "lengths": [[r.prompt_len, len(r.tokens)] for r in sample],
               "program": {**_summary(gaps), "correct": ok,
                           "checks": checks}}
        if args.control:
            ref = check.reference_logits(cell.reference, params, arch,
                                         sample)
            ctl = check.reference_logits(cell.reference, params, arch,
                                         sample, "fp8")
            summary = _summary([check.gaps(lg, c.argmax(-1).cpu())
                                for lg, c in zip(ref, ctl)])
            ok, checks = check.verdict(cell.limits, summary["mean"], 0,
                                       len(sample), summary["share_nonzero"])
            rec["control"] = {**summary, "correct": ok, "checks": checks}
            del ref, ctl
        rec["seconds"] = time.perf_counter() - t
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(line + "\n")
        del params, loop, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
