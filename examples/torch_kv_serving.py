"""LLM serving with a Honeycomb-indexed paged KV cache, on the PyTorch
port (twin of examples/kv_serving.py, which runs the JAX reference).

Demonstrates the paper's technique as a serving-framework feature: page
tables are an ordered store (host writes allocate/free pages, the device
path resolves block tables in batch, through the fused read kernel on a
GPU), continuous batching, and token generation on a reduced qwen config
with the port's own seeded random weights.

Run:  PYTHONPATH=src python examples/torch_kv_serving.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import ServingEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu (the plain PyTorch path)")
args = ap.parse_args()

cfg = get_smoke_config("qwen2p5_3b")
eng = ServingEngine(cfg, batch_size=4, max_seq=128, page_size=16,
                    device=args.device)

rng = np.random.default_rng(0)
t0 = time.perf_counter()
rids = [eng.submit(rng.integers(1, cfg.vocab, (rng.integers(8, 24),)),
                   max_new_tokens=8) for _ in range(8)]
outs = eng.run_until_done()
dt = time.perf_counter() - t0

print(f"served {len(outs)} requests / {eng.stats['tokens']} tokens "
      f"in {dt:.1f}s")
print(f"engine stats: {eng.stats}")
t = eng.kv.table
print(f"honeycomb page table: puts={t.stats.puts} deletes={t.stats.deletes} "
      f"log-appends={t.stats.fast_path} merges={t.stats.merges}")
print(f"page-table sync commands (the 'PCIe' metric the log block "
      f"amortizes): {t.tree.pt.sync_commands}")
for rid in rids[:4]:
    print(f"  rid {rid}: {outs[rid]}")
