"""Quickstart on the PyTorch port: the Honeycomb ordered store in five
minutes (twin of examples/quickstart.py, which runs the JAX reference).

Covers the paper's core loop: host writes (PUT/UPDATE/DELETE, log blocks,
merges, splits) + device reads (batched wait-free GET/SCAN with MVCC
snapshots, through the fused read kernel on a GPU) + the PCIe-sync
accounting the design exists to amortize.  Prints the same lines as the
reference's quickstart.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import random

from repro_torch.core import HoneycombConfig, HoneycombStore
from repro_torch.core.keys import int_key

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu (the plain PyTorch path)")
args = ap.parse_args()

random.seed(7)

# a store with small nodes so structure changes are visible at toy scale
store = HoneycombStore(HoneycombConfig(node_cap=16, log_cap=4,
                                       n_shortcuts=4), device=args.device)

# --- host-side writes (the CPU half of the paper) --------------------------
print("== writes ==")
for i in range(500):
    store.put(int_key(i), f"value-{i}".encode())
for i in range(0, 500, 7):
    store.update(int_key(i), f"updated-{i}".encode())
for i in range(0, 500, 13):
    store.delete(int_key(i))
s = store.stats
print(f"puts={s.puts} updates={s.updates} deletes={s.deletes}")
print(f"fast-path appends={s.fast_path} merges={s.merges} "
      f"splits={s.splits} tree-height={store.tree.height}")

# --- device-side batched reads (the FPGA half) ------------------------------
print("\n== batched GET (wait-free, MVCC) ==")
keys = [int_key(i) for i in (0, 1, 7, 13, 490, 499)]
for k, v in zip(keys, store.get_batch(keys)):
    print(f"  {int.from_bytes(k, 'big'):4d} -> {v}")

print("\n== batched SCAN (floor-start semantics, Section 3.3) ==")
ranges = [(int_key(100), int_key(104)), (int_key(250), int_key(254))]
for (lo, hi), items in zip(ranges, store.scan_batch(ranges)):
    lo_i, hi_i = int.from_bytes(lo, 'big'), int.from_bytes(hi, 'big')
    got = [(int.from_bytes(k, 'big'), v.decode()) for k, v in items]
    print(f"  scan[{lo_i},{hi_i}] -> {got}")

# --- the synchronization the log blocks amortize ----------------------------
print("\n== host->accelerator sync accounting ==")
print(f"page-table commands: {store.tree.pt.sync_commands} "
      f"(1 per merge/split, NOT 1 per write)")
print(f"read-version updates: {store.tree.versions.device_updates}")
print(f"garbage list: {len(store.tree.gc.list)} entries; "
      f"reclaimed now: {store.collect_garbage()}")
