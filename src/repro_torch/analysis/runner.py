"""honeylint runner for the port: the lint pass and the kernel check,
one JSON report (port of ``repro.analysis.runner``).

EpochSan is exercised separately: it is a *runtime* sanitizer, so the
port's store, replication and service tests are re-run under
``HONEYCOMB_EPOCHSAN=1``.

    python -m repro_torch.analysis [--json PATH] [--device cuda|cpu]
                                   [--no-baseline]

``--device`` defaults to ``cuda``: the kernel check then runs the CUDA
kernels and raises without a card; ``--device cpu`` audits the plain
versions.  Exits 1 on any finding.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.analysis")
    ap.add_argument("--json", default=None,
                    help="write the combined findings report here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernel check runs the entry points")
    ap.add_argument("--no-baseline", action="store_true")
    args = ap.parse_args(argv)

    from . import kernel_check, lint

    lint_findings, baselined = lint.run_lint(
        baseline=None if args.no_baseline else lint.BASELINE_PATH)
    kernel_findings, runs = kernel_check.run_kernel_checks(args.device)
    findings = lint_findings + kernel_findings
    for f in findings:
        print(f)
    report = {
        "lint": [f.to_json() for f in lint_findings],
        "kernel_check": [f.to_json() for f in kernel_findings],
        "baselined": baselined,
        "entry_points": len(runs),
        "device": args.device,
        "entries": kernel_check.summary(runs, kernel_findings, args.device),
        "ok": not findings,
    }
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1) + "\n")
        print(f"report -> {out}")
    print(f"honeylint: {len(lint_findings)} lint + "
          f"{len(kernel_findings)} kernel finding(s), "
          f"{baselined} baselined, "
          f"{report['entry_points']} kernel entry points on {args.device}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
