"""End-to-end training driver (port of ``repro.launch.train``): the same
arguments, plus ``--device``.

Smoke scale, on the GPU or the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --steps 50 [--device cpu]

Without ``--smoke`` the architecture's full config trains on one card at
``--batch`` x ``--seq``.  Checkpoint/restart and straggler handling live
in ``repro_torch.train.train_loop``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

from ..configs import get_config, get_smoke_config
from ..train.train_loop import LoopConfig, build_smoke_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, single device")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = build_smoke_loop(
        cfg, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        loop_cfg=LoopConfig(total_steps=args.steps,
                            ckpt_every=max(args.steps // 2, 1),
                            log_every=max(args.steps // 10, 1)),
        device=args.device)
    if args.resume and loop.restore_latest():
        print(f"resumed from step {loop.step}")
    try:
        summary = loop.run()
    finally:
        loop.pipeline.close()
    for m in loop.metrics_log:
        print(json.dumps(m))
    print("summary:", json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
