"""End-to-end serving driver (continuous batching + Honeycomb paged KV),
port of ``repro.launch.serve``: the same arguments, plus ``--device``.

Smoke scale, on the GPU or the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --smoke --requests 8 [--device cpu] [--trace spans.json]

``--trace`` writes the engine's spans (core/telemetry.SPANS) as Chrome
trace-event JSON on the profiler's timeline, for Perfetto.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..configs import get_config, get_smoke_config
from ..core.telemetry import CLOCK, SPANS
from ..serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--trace", metavar="PATH",
                    help="write the spans as Chrome trace-event JSON")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    eng = ServingEngine(cfg, batch_size=args.batch, max_seq=256,
                        page_size=16, device=args.device)
    rng = np.random.default_rng(0)
    t0 = CLOCK()
    for _ in range(args.requests):
        eng.submit(rng.integers(1, cfg.vocab, (args.prompt_len,)),
                   max_new_tokens=args.new_tokens)
    outs = eng.run_until_done()
    dt = CLOCK() - t0
    print(f"served {len(outs)} requests, {eng.stats['tokens']} tokens "
          f"in {dt:.2f}s ({eng.stats['tokens'] / dt:.1f} tok/s) on "
          f"{eng.device}")
    print(f"stats: {eng.stats}; honeycomb page-table "
          f"puts={eng.kv.table.stats.puts} "
          f"deletes={eng.kv.table.stats.deletes} "
          f"merges={eng.kv.table.stats.merges}")
    for rid, toks in list(outs.items())[:3]:
        print(f"  rid {rid}: {toks}")
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(SPANS.chrome_trace(), f)
        print(f"spans: {len(SPANS)} written to {args.trace}")
    return outs


if __name__ == "__main__":
    main()
