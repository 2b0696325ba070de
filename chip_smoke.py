#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Honeycomb once on one NVIDIA GPU.

Builds the port's nine CUDA kernels from the seven sources in this
checkout (one ``nvcc`` per source, all started together), then drives eight
numbered paths, the store's at the paper's node geometry (the default
``HoneycombConfig``: 32 B keys, 16 B values, 1273-word node images), each
with every kernel's launch count set to 0 just before it and read just
after:

1. The single-shard ``HoneycombStore`` with 2^17 8-byte keys: GET batches
   and 8-key SCAN batches through the fused read kernel, about a thousand
   updates, deletes and inserts so that the next read takes a delta sync
   through the row-scatter kernel, and the reads again.  Every answer is
   checked against a dict model with floor-start SCAN semantics and
   against the store's host tree.  A torch.profiler trace of a few read
   batches gives the device's busy share.
   Then the KSU and RSU over that path's last snapshot: each of its GET
   batches walks the levels the read path descends, and at every level
   the floor search kernels (``key_search_image`` over the shortcut block
   and the sorted block, ``key_search`` over the decoded sorted block)
   must equal their plain versions, the read path's shortcut floor and its
   two-stage segment floor; the leaf-merge kernel orders every leaf row
   of the image and must equal its plain version and the stable order of
   the read path's own leaf ranks.  The image-mode search is also held
   to its plain version on synthetic rows: a block that needs its chunk
   loop and key widths of its generic instance; the block-mode search on
   synthetic operands (the stores' width and the generic instance's, a
   block in chunks, a key in passes of lanes, valid masks all zero, full
   and not a prefix, keys at a 4-byte offset); the leaf merge on wild
   leaves of both its instances (ranks that wrap, a live rank of
   INT32_MAX, ties).
2. The CPU baseline beside the store: the port's ``CpuOrderedStore``
   (the paper's eRPC-Masstree stand-in) takes path 1's load (same keys,
   same order) and its writes; path 1's GET and SCAN batches made after
   the writes go through both stores in turns (baseline batch, store
   batch, ...) with EpochSan off, every answer of both checked against
   the dict model, and each store's puts/s, GET ops/s and SCAN ops/s on
   the card's host print beside the baseline's ``CpuStoreStats`` and the
   byte model.  Then the live store dry run
   (``repro_torch.launch.store_dryrun``): ``live_sharded_smoke`` (4
   shards, 1,024 keys) and ``live_replicated_smoke`` (2 shards x 2
   replicas, 512 keys) at their defaults, whose own assertions hold the
   fused reads to the per-level reference path on every shard and
   follower; their sync, feed, cache and telemetry meters print a JSON
   line each.
3. The range-sharded, replicated ``ShardedHoneycombStore``: 2 shards x 3
   replicas (round-robin reads, the log-shipped follower feed, a flat
   relay topology) over 2^18 keys.  Update epochs replay each epoch's
   wire log on every follower through the log-replay kernel, or fall back
   to the row-scatter delta when the tree shape changed; an insert epoch,
   a GC epoch and a paused follower's full catch-up follow.  After every
   flip each in-sync follower's image and cache tier must equal its
   primary's bit for bit, and every GET/SCAN answer (16 SCANs of each
   batch straddle the shard boundary) must equal the dict model.
4. The typed service front end over the legacy per-field layout:
   ``HoneycombService`` (pipelined, telemetry on, 5% of requests traced)
   over a 2-shard, 2-replica ``ShardedHoneycombStore(layout="legacy")``
   of 2^18 keys loaded through the service.  16 epochs of 2,048 ops (20%
   PUT, 10% UPDATE, 5% DELETE, 50% GET, 15% 8-key SCAN), each op
   round-tripped through the wire codec, then 2 epochs through a second,
   serial service.  Every delta sync, primary or follower, is one launch
   of the multi-field scatter kernel; reads take the per-level reference
   path.  Every response must equal a dict model, read stamps must never
   go back per key nor a follower's lag its primary's, every follower's
   24 field tensors must equal its primary's after every drain, and each
   primary's snapshot must equal a fresh full publish of its heap at the
   end.
5. The serving engine: ``ServingEngine`` with qwen2.5-3b at its full
   widths and depth (random bf16 weights from ``--seed``), 8 slots, pages
   of 256 tokens, a ``PagedKVCache`` whose page table is a
   ``HoneycombStore`` on the card.  16 requests of 1,024-4,000 prompt
   tokens and 32 new tokens each: every decode step looks its block
   tables up with one fused GET batch and runs the paged-attention kernel
   in each of the 36 layers.  The page table's puts and deletes must
   equal a dict model, every served token's logit must lie within a
   tolerance of its row's maximum in a plain full forward, and
   teacher-forced decode logits, through the kernel and through the plain
   attention, must agree with that forward.
6. The MoE, SSM and hybrid models served the same way, three engines one
   after another (each freed before the next), 8 slots, pages of 256
   tokens, 16 pages a sequence, random bf16 weights from ``--seed``:
   olmoe-1b-7b (64 experts, top 8) and mamba2-1.3b at their full widths
   and depth, jamba-v0.1-52b at its full widths cut to one superblock of
   8 layers ('MMMGMMMM'; the whole model's 103 GB does not fit in the
   card's 80).  8 requests of 1,024-2,048 prompt tokens and 16 new
   tokens each: every decode step looks its block tables up with one
   fused GET batch, runs paged attention in each attention layer (16,
   none, 1) and keeps each mamba layer's state at its request's slot
   row.  The parameter counts must equal the reference's, the page
   table a dict model, every served token's logit lie within its
   engine's ``MOE_SSM_TOL`` of its row's maximum in a full forward, and
   a share of them at least that entry's floor be the forward's argmax;
   for the mamba models prefill of all but 8 prompt tokens and 8
   teacher-forced decode steps must give the full forward's logits (the
   chunked scan against the recurrence), in bf16 within that entry's
   handoff tolerance, every MoE route forced to the forward's (with its
   own routes within ``MOE_OWN_ROUTES_TOL``, the flipped routes
   counted), and
   with f32 weights within ``F32_TOL``, as must mamba2's served tokens
   through a second engine with those f32 weights (its slot rows held
   tight); on one olmoe layer in f32 ``moe_dense`` and ``moe_ragged``
   must agree on a decode batch and a 2,048-token prefill (both timed).
7. Encoder-decoder and embedding inputs through ``launch/steps.py``, two
   models one after the other at full widths and depth, random bf16
   weights from ``--seed``: pixtral-12b (40 layers, 12,247,782,400
   parameters) prefilled from 8 sequences of 2,048 seeded embeddings
   (its vision frontend is a stub in the reference too), and
   seamless-m4t-medium (12 encoder and 12 decoder layers, 977,860,608)
   from 8 sequences of 2,048 seeded tokens, each with 256 seeded encoder
   frames.  ``steps.prefill_step`` encodes and prefills; its pages go into
   decode pools of ``steps.decode_cache_abstract``'s shapes (seq_len
   4,096, pages of 256), and 15 greedy ``steps.decode_step``s follow,
   seamless's against the ``enc_out`` its prefill returned, each running
   paged attention in every layer.  The parameter counts must equal the
   reference's, ``enc_out`` be finite and [8, 256, 1024], every served
   token's logit lie within ``ENCDEC_TOL`` of its row's maximum in a
   plain full forward per sequence, a share of them at least that
   entry's floor be its argmax, the same decode steps through the plain
   attention stay within that bound of the kernel's, and seamless with
   f32 weights give the f32 full forward's logits within
   ``ENCDEC_F32_TOL`` through prefill and decode.
8. Training, after path 7's models are freed: qwen2.5-3b at its full
   widths and depth (3,397,103,616 random bf16 parameters from ``--seed``,
   f32 AdamW moments) trained 4 steps by ``TrainLoop`` over
   ``launch/steps.train_step``: train_4k's sequence of 4,096 tokens, its
   global batch of 256 cut to 4 (the first cut), in 4 microbatches of
   1 x 4,096 with remat, from ``SyntheticSource``; no full-size
   checkpoint (the second cut: parameters and optimizer state would take
   ~34 GB on disk).  Every loss and gnorm must be finite, the parameters
   must move and no kernel of the port may launch.  Step time, tokens/s,
   the peak allocation, the busy share of one more step under the
   profiler and 6 * N * tokens a step (N without the embedding table)
   against the dense bf16 peak print as figures.
   Then qwen2.5-3b at full widths cut to 2 layers in f32, 1 x 256 tokens
   with labels of -1: the loss and every gradient leaf on the card
   against the port's CPU run, and ``remat=False`` against ``remat=True``
   on the card, within ``TRAIN_CHECK_TOL``.  Then the restart drill at
   examples/torch_train_lm.py's size under deterministic algorithms: 20
   steps straight against 10, a restart from the newest checkpoint and
   10 more, every leaf equal bit for bit; the checkpoint catalog's steps,
   floor lookups and retention against a dict model; a restored bf16 leaf
   equal to the saved one; and the example itself as a subprocess, which
   must print LEARNING.  The drill is the part that puts, scans and
   deletes through the catalog's on-card ``HoneycombStore``: its counts
   are set to 0 just before it and must read 0 after (the catalog uses
   the store's host operations only).  The ``train`` entry of each
   kernel's ``launches_by_path`` is the sum of the loop's and the
   drill's, and is 0.

Then each kernel is held against its plain PyTorch version on the card at
the shapes its path gave it; the log replay also at D = 1, 32, 1,024 and
4,096 entries, and with a bad row and a bad slot (each must raise and
write nothing; the call right after must be exact), and it is timed at
the path's usual D and at D = 1,024; the paged-attention kernel also at the
attention shapes of gemma2-27b (32 heads, 16 KV heads, soft-capping, a
4,096-position window) and gemma3-12b (head dim 256, a 1,024-position
window) on seeded synthetic pools, and its span plan is printed; and at
the olmoe (G = 1) and jamba (G = 4) engines' own shapes and live lengths, and
at pixtral's (G = 4, D = 128) and seamless's (G = 1, D = 64) after path 7's
decode steps.  Each
kernel's device time comes from a torch.profiler trace with the L2 cache
flushed before every launch (the block-mode search and the leaf merge
in two turns); the time per call through its Python wrapper and the
plain version's time come from CUDA events.  The fused read's, paged
attention's, the block-mode search's and the leaf merge's times before
their redesign are printed beside this run's.  Both delta-sync scatters' byte bound counts the
distinct dirty rows only (``scatter_bound_ms``).

EpochSan (``repro_torch.analysis.epochsan``) runs in strict mode over the
correctness phases of paths 1, 3 and 4 and is off in every kernel timing
(profiler and CUDA-event loops) and in path 2; the host-clock latencies
those phases print include its checks.  The KSU/RSU entry points pass no
seam: no store path calls them.  Each of paths 1, 3 and 4 prints its
meters as one ``{"epochsan": {...}}`` line, and any violation, or a seam
the path passes left uncounted, fails the run.  A read of a delta staged and not
flipped must raise ``standby-read`` before any launch.  Last, the kernel
check of ``python -m repro_torch.analysis`` runs on the card: every entry
point of ``kernels/ops.py`` once on small seeded inputs, one launch of its
own kernel, its pinned read-backs, in-place scatters, and shared memory
under the device's limit; it prints one ``{"kernel_check": [...]}`` line
and any finding fails the run.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py [--keys-log2 17] [--replicated-keys-log2 18]
                          [--service-keys-log2 18] [--seed 0]

It prints the timings, the card's name and power limit, a
``{"kernels": [...]}`` line and last ``{"ok": true, "device": {...}}``.
It exits non-zero, printing no result, when no CUDA device is present or
when any check fails.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import gc
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
# update epochs of the replicated store: 8 writes to a shard's random
# leaves keep an epoch replayable about half the time (a leaf log holds
# 16 entries), so 64 epochs give each shard a few dozen log-feed epochs
EPOCHS = 64
EPOCH_WRITES = 8
# the service path: pipelined epochs, then serial ones, of SERVICE_OPS ops
# in benchmarks/service_smoke.py:mixed_ops's mix
SERVICE_EPOCHS = 16
SERIAL_EPOCHS = 2
SERVICE_OPS = 2048
# the serving path: qwen2.5-3b, 8 slots, pages of 256 tokens, 32 pages a
# sequence; 16 requests of 1,024-4,000 prompt tokens and 32 new tokens
SERVING_SLOTS = 8
SERVING_PAGE = 256
SERVING_MAX_SEQ = 8192
SERVING_REQUESTS = 16
SERVING_NEW_TOKENS = 32
SERVING_TRACE_AT = 10           # trace decode steps 10-12 (no prefill)
TEACHER_STEPS = 8
QWEN_PARAMS = 3_397_103_616     # the reference's qwen2.5-3b param_count()
BF16_FLOPS = 989e12             # H100 SXM dense bf16 (data sheet)
# logits of the random-weight model are about N(0, 1) (an RMS-normed
# 2048-wide state times an lm_head of std 2048**-0.5); bf16 weights and
# activations round at other steps in a full forward and in prefill +
# decode, so their logits may differ by a few bf16 ulps at the top of
# that range (0.03 each) after 36 layers:
TEACHER_TOL = 0.25              # prefill/decode vs the full forward
TOKEN_GAP_TOL = 0.25            # a served token's logit below the row max
# kernel vs plain attention inside the same decode steps: only the f32
# summation order of the attention differs, but a one-ulp bf16 difference
# in an early layer's output grows through the later layers to the size
# of any other rounding difference, so the bound is the same
KERNEL_VS_PLAIN_TOL = 0.25
# the kernels' device times before their redesign (profiler, L2 flushed,
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
BEFORE_MS = {"fused_get": 0.0354, "fused_scan": 0.0365,
             "paged_attention": 0.2887, "key_search": 0.0040,
             "leaf_merge": 0.0290}
# synthetic shapes of two more carried configs for the paged-attention
# kernel: (name, H, KVH, D, softcap, window) of gemma2-27b and gemma3-12b
PAGED_SHAPES = (("gemma2-27b", 32, 16, 128, 50.0, 4096),
                ("gemma3-12b", 16, 8, 256, 0.0, 1024))
# the MoE/SSM serving path: three engines of 8 slots, pages of 256 tokens
# and 16 pages a sequence; 8 requests of 1,024-2,048 prompt tokens and 16
# new tokens each.  (arch, layers kept or None for all, the reference's
# param_count() and active_param_count() at those layers)
MOE_SSM_MODELS = (
    ("olmoe-1b-7b", None, 6_919_096_320, 1_281_951_744),
    ("mamba2-1.3b", None, 1_446_812_672, 1_446_812_672),
    ("jamba-v0.1-52b", 8, 13_267_656_416, 3_402_653_408))
MOE_SSM_MAX_SEQ = 4096
MOE_SSM_REQUESTS = 8
MOE_SSM_PROMPTS = (1024, 2048)  # prompt tokens, least and most
MOE_SSM_NEW_TOKENS = 16
MOE_SSM_TRACE_AT = 4            # trace decode steps 4-6
MOE_IMPL_ARCH = "olmoe-1b-7b"   # the dense/ragged MoE check's model
MOE_PREFILL_TOKENS = 2048       # and its prefill
# per engine, the bf16 checks' bounds, each set before the card run from
# scripts/torch_serving_tolerance.py (smoke widths at these depths and the
# full configs' vocabularies, seeds 0-5) by one rule: 1.5 times the
# rehearsal's largest figure, rounded up to a multiple of 1/32; the
# argmax-agreement floor is its lowest share less 0.15.  "gap": a served
# token's logit below its row's max in a full forward (largest 0.7812,
# 0.4375, 0.3125); "agree": served tokens that are the forward's argmax
# (lowest 111, 119, 120 of 128); "handoff": prefill + teacher-forced
# decode against the full forward with every MoE route forced to the
# forward's (largest 0.5735 for mamba2, 0.1953 for jamba; with their own
# routes jamba's reached 1.7852 after 2 flipped routes)
MOE_SSM_TOL = {
    "olmoe-1b-7b": {"gap": 1.1875, "agree": 111 / 128 - 0.15},
    "mamba2-1.3b": {"gap": 0.65625, "agree": 119 / 128 - 0.15,
                    "handoff": 0.875},
    "jamba-v0.1-52b": {"gap": 0.46875, "agree": 120 / 128 - 0.15,
                       "handoff": 0.3125}}
# the handoff with its own MoE routes, where a flipped route moves a token
# by an expert's share: the first rehearsal's bound (its largest figure,
# 1.5469, times 1.5, rounded up), held beside the forced one
MOE_OWN_ROUTES_TOL = 2.5
# the handoff again with f32 weights, where the chunked scan and the
# recurrence differ in summation order only (the rehearsal's largest f32
# figure: 0.0006, after 48 mamba2 layers); and mamba2's served tokens
# through an f32 engine, which has no KV pool to round to bf16 and no
# route to flip (the rehearsal's f32 gaps: 0.0 at every seed)
F32_TOL = 0.01
# moe_dense against moe_ragged on one olmoe layer in f32: the same routes,
# sums of 2,048 (d) and 1,024 (f) products in other orders
MOE_IMPL_TOL = dict(rtol=1e-4, atol=1e-4)
# path 7, encoder-decoder and embedding inputs through launch/steps.py:
# (arch, the reference's param_count()), each at full widths and depth;
# 8 sequences of 2,048 prompt positions (pixtral: embeddings; seamless:
# tokens and 2,048 / 8 = 256 encoder frames), decode caches of
# decode_cache_abstract's shapes at seq_len 4,096 (16 pages of 256 a
# sequence), 16 greedy tokens (the prefill's and 15 decode steps)
ENCDEC_MODELS = (("pixtral-12b", 12_247_782_400),
                 ("seamless-m4t-medium", 977_860_608))
ENCDEC_BATCH = 8
ENCDEC_PROMPT = 2048
ENCDEC_SEQ = 4096
ENCDEC_NEW = 16
ENCDEC_TRACE_AT = 4             # trace decode steps 4-6
# per model, the bf16 checks' bounds, set before the card run from
# scripts/torch_serving_tolerance.py --encdec (smoke widths at these
# depths, the full vocabularies, 8 sequences of 128 positions, seeds 0-5)
# by MOE_SSM_TOL's rule: 1.5 times the rehearsal's largest figure, rounded
# up to a multiple of 1/32; the floor its lowest share less 0.15.  "gap":
# a served token's logit below its row's max in a plain full forward
# (largest 0.0938 for pixtral, 0.0312 for seamless), also the bound of the
# same decode steps through the plain attention against the kernel's
# logits (on the CPU both are the plain version: 0.0); "agree": served
# tokens that are that forward's argmax (lowest 118 and 120 of 128)
ENCDEC_TOL = {
    "pixtral-12b": {"gap": 0.15625, "agree": 118 / 128 - 0.15},
    "seamless-m4t-medium": {"gap": 0.0625, "agree": 120 / 128 - 0.15}}
# seamless with f32 weights: prefill + decode steps fed the served tokens
# against the f32 full forward, path 6's F32_TOL (the rehearsal's largest
# f32 figure: 0.000003 at every seed)
ENCDEC_F32_TOL = F32_TOL
# path 8, training: qwen2.5-3b at full widths and depth, train_4k's
# sequence of 4,096 with its global batch of 256 cut to 4 (4 microbatches
# of 1 x 4,096, remat on), 4 steps and one more traced; no full-size
# checkpoint (parameters and AdamW state would be ~34 GB on disk).  Then
# the card against the CPU at full widths cut to 2 layers in f32, 1 x 256
# tokens, within 1e-4 of each gradient leaf's largest magnitude (the
# frameworks' f32 sums in other orders, as tests/test_torch_lm_loss.py
# holds them); the restart drill of 20 steps at the example's size
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_ACCUM = 4
TRAIN_STEPS = 4
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_TOKENS = 256
TRAIN_CHECK_TOL = 1e-4
DRILL_STEPS = 20
# entries of the log replay's checks against its plain version; then
# (entries, position of the bad pair) of its rejected calls
REPLAY_CHECK_D = (1, 29, 1000, 4000)
REPLAY_REJECT = ((3, 2), (1000, 900))
# entries of the log replay's second timing, beside the main path's size
REPLAY_TIMING_D = 1024


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


# Idle time traced before and after the window.  The profiler keeps only
# the device activities inside its capture range, and it places them on
# the host's clock; that placement has been seen shifted earlier by
# milliseconds, so the first launches of an unguarded trace fell before
# the range and were lost (scripts/torch_profiler_drops.py measures it).
TRACE_GUARD_S = 0.05


def device_events_raw(fn, guard_s: float = TRACE_GUARD_S):
    """Run ``fn`` under torch.profiler, inside a ``smoke_window``
    annotation, and return the trace's events.  The trace opens
    ``guard_s`` before the window, with the device idle, and closes as
    long after it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(guard_s)
        with record_function("smoke_window"):
            fn()
            torch.cuda.synchronize()
        time.sleep(guard_s)
    return prof.events()


def device_events(fn):
    """Run ``fn`` under torch.profiler.  Returns the (name, microseconds)
    of every device activity (kernel, copy, set) it caused, and the
    microseconds of the whole window on the host's clock."""
    from torch.autograd import DeviceType
    evs = device_events_raw(fn)
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


def device_ms(fns: list, reps: int, match: str, flush: torch.Tensor,
              per_call: int = 1, min_traced: float = 0.9,
              tries: int = 3) -> float:
    """Mean device time per call of the kernels whose names hold
    ``match``, ``per_call`` launches per call, cycling through ``fns``,
    from the profiler's trace.  ``flush`` (larger than the 50 MB L2) is
    overwritten before each call, because the main path finds its data
    cold.  The host's work around the launches is left out.  Should the
    profiler still lose device events (``device_events_raw`` guards the
    trace's ends against the loss seen so far), a trace holding fewer
    than ``min_traced`` of the launches is taken again, up
    to ``tries`` traces, each retake half as long as the trace before (at
    least 16 calls: drops have held traces of 64 launches to 52 three
    times in a row; a figure from a retake is announced on a line of its
    own), and the mean is over the launches traced."""
    for fn in fns:
        fn()

    def run(k):
        for r in range(k):
            flush.fill_(r)
            fns[r % len(fns)]()
    for attempt in range(tries):
        k = max(min(reps, 16), reps >> attempt)
        n = k * per_call
        us = [t for name, t in device_events(lambda: run(k))[0]
              if match in name]
        check(len(us) <= n, f"the profiler traced {len(us)} launches of "
              f"{match} for {n} launches")
        if len(us) >= n * min_traced:
            if attempt:
                print(f"device_ms: {match} from retake {attempt} ({k} "
                      f"calls, {len(us)} launches traced)")
            return sum(us) / len(us) * per_call / 1e3
    raise SmokeFailure(f"the profiler traced {len(us)} launches of {match} "
                       f"for {n} launches in the last of {tries} traces")


_FILL_NAMES = {}    # id(flush) -> the names of its fill kernels


def device_all_ms(fns: list, reps: int, flush: torch.Tensor,
                  min_traced: float = 0.9, tries: int = 3) -> float:
    """Mean device time per call of EVERY device activity that ``fns``
    cause (a library call may launch several kernels), from the
    profiler's trace, with ``flush`` overwritten before each call; the
    flush's own fill is told apart by its name and left out.  A trace
    holding fewer than ``min_traced`` of the fills is taken again; the mean
    is over the calls whose fill the trace holds."""
    # the flush's fill kernels by name, filled as the run fills, probed once
    # a flush tensor (every trace is one more chance for the profiler to
    # drop events); a probe trace that the profiler dropped whole is taken
    # again
    fill = _FILL_NAMES.get(id(flush), set())
    for _ in range(tries):
        if fill:
            break
        fill = {name for name, _ in device_events(
            lambda: [flush.fill_(r) for r in range(8)])[0]}
    check(bool(fill), f"the profiler traced no flush fill, in each of "
          f"{tries} traces")
    _FILL_NAMES[id(flush)] = fill
    for fn in fns:
        fn()

    def run():
        for r in range(reps):
            flush.fill_(r)
            fns[r % len(fns)]()
    for _ in range(tries):
        evs = device_events(run)[0]
        fills = sum(1 for name, _ in evs if name in fill)
        if fills >= reps * min_traced:
            return sum(t for name, t in evs if name not in fill) \
                / fills / 1e3
    print(f"  the flush's fills: {sorted(fill)}", file=sys.stderr)
    print_activities(evs, "untimed trace", top=12)
    raise SmokeFailure(f"the profiler traced {fills} of {reps} calls, in "
                       f"each of {tries} traces")


def image_clone_ms(image: torch.Tensor) -> float:
    """Time of one clone of a node image, by CUDA events over 32 clones
    back to back.  A clone of a full image moves tens of MB each way, far
    longer than its host-side enqueue, so the device sets this time.  (The
    profiler's trace of such copies can miss most of them.)"""
    return cuda_ms([image.clone], 32)


def epochsan_report(path: str, san, need) -> None:
    """Print a path's EpochSan meters as one JSON line; fail on any
    violation or on a counter of ``need`` (the seams the path passes)
    left at 0."""
    st = dataclasses.asdict(san.stats)
    print(json.dumps({"epochsan": {"path": path, **st}}))
    check(st["violations"] == 0 and not san.violations,
          f"{path}: EpochSan recorded {st['violations']} violation(s)")
    for name in need:
        check(st[name] > 0, f"{path}: EpochSan counted no {name}")


def max_abs_err(want, got) -> int:
    """Largest absolute difference over every field of two results."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(want, got))


def scatter_bound_ms(d: int, W: int, D: int) -> float:
    """The least time of one delta's row copy (both scatter kernels): its
    d distinct dirty rows of W words read once and written once, and its
    D row indices read, over the memory rate.  The D - d pad repeats
    carry the data of the row before them and move nothing."""
    return (2 * d * W * 4 + D * 4) / HBM_BYTES_PER_S * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys-log2", type=int, default=17,
                    help="keys of the single-shard store")
    ap.add_argument("--batches", type=int, default=32,
                    help="GET batches and SCAN batches per read phase of "
                         "the single-shard store")
    ap.add_argument("--writes", type=int, default=1000)
    ap.add_argument("--replicated-keys-log2", type=int, default=18,
                    help="keys of the 2-shard, 3-replica store")
    ap.add_argument("--service-keys-log2", type=int, default=18,
                    help="keys of the legacy-layout store behind the "
                         "service")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card {card}")

    # ---- build every kernel of the eight paths, one nvcc per source --------
    t0 = time.perf_counter()
    reports = build.build(build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.3f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    flush = torch.empty(128 << 20, dtype=torch.int8, device=dev)

    print("== single-shard store ==")
    kernels, launches, (snap, batches), replay = single_shard_path(
        args, dev, flush)
    print("== KSU/RSU over the live snapshot ==")
    t0 = time.perf_counter()
    ksu_rsu, ksu_launches = ksu_rsu_path(args, dev, flush, snap, batches)
    kernels += ksu_rsu
    print(f"KSU/RSU path with its timings: {time.perf_counter() - t0:.3f} s")
    del snap, batches
    print("== CPU baseline beside the store ==")
    t0 = time.perf_counter()
    base_launches, live_launches = baseline_path(dev, replay)
    del replay
    print(f"baseline phase with the live smokes: "
          f"{time.perf_counter() - t0:.3f} s")
    print("== 2-shard, 3-replica store ==")
    replay, repl_launches, scatter = replicated_path(args, dev, flush)
    row_scatter = next(k for k in kernels if k["name"] == "row_scatter")
    row_scatter["max_abs_err"] = max(row_scatter["max_abs_err"],
                                     scatter["max_abs_err"])
    row_scatter["D_replicated"] = scatter["D"]
    print(f"row_scatter held against its plain version at D = "
          f"{row_scatter['D']} (single shard) and D = {scatter['D']} "
          f"(replicated fallback deltas): max abs err "
          f"{row_scatter['max_abs_err']}")
    kernels.append(replay)
    print("== service over the legacy layout ==")
    multi, svc_launches = service_legacy_path(args, dev, flush)
    kernels.append(multi)
    print("== serving engine: qwen2.5-3b over a Honeycomb page table ==")
    t0 = time.perf_counter()
    paged, serve_launches = serving_path(args, dev, flush)
    kernels.append(paged)
    print(f"serving path with its checks and timings: "
          f"{time.perf_counter() - t0:.3f} s")
    print("== serving engine: olmoe-1b-7b, mamba2-1.3b, jamba-v0.1-52b "
          "(one superblock) ==")
    t0 = time.perf_counter()
    moe_ssm_launches, moe_ssm_shapes = moe_ssm_serving_path(args, dev,
                                                            flush)
    paged["shapes"] += moe_ssm_shapes
    paged["max_abs_err"] = max([paged["max_abs_err"]]
                               + [x["max_abs_err"] for x in moe_ssm_shapes])
    print(f"MoE/SSM serving path with its checks and timings: "
          f"{time.perf_counter() - t0:.3f} s")
    print("== encoder-decoder and embedding inputs through launch/steps.py: "
          "pixtral-12b, seamless-m4t-medium ==")
    t0 = time.perf_counter()
    encdec_launches, encdec_shapes = encdec_serving_path(args, dev, flush)
    paged["shapes"] += encdec_shapes
    paged["max_abs_err"] = max([paged["max_abs_err"]]
                               + [x["max_abs_err"] for x in encdec_shapes])
    print(f"encoder-decoder path with its checks and timings: "
          f"{time.perf_counter() - t0:.3f} s")
    print("== training: qwen2.5-3b at full size, the card against the CPU, "
          "the restart drill ==")
    t0 = time.perf_counter()
    train_launches = training_path(args, dev, card)
    print(f"training path with its checks: {time.perf_counter() - t0:.3f} s")
    print("== kernel check: every entry point of kernels/ops.py ==")
    t0 = time.perf_counter()
    kernel_check_phase(dev)
    print(f"kernel check: {time.perf_counter() - t0:.3f} s")
    for k in kernels:         # each kernel's launches over the main paths
        by_path = {"single_shard": launches[k["name"]],
                   "replicated": repl_launches[k["name"]],
                   "service_legacy": svc_launches[k["name"]],
                   "ksu_rsu": ksu_launches[k["name"]],
                   "baseline": base_launches[k["name"]],
                   "live_smokes": live_launches[k["name"]],
                   "serving": serve_launches[k["name"]],
                   "serving_moe_ssm": moe_ssm_launches[k["name"]],
                   "serving_encdec": encdec_launches[k["name"]],
                   "train": train_launches[k["name"]]}
        check(by_path["train"] == 0, f"{k['name']} launched in training")
        k["launches_by_path"] = by_path
        k["launches"] = sum(by_path.values())
        check(k["launches"] > 0, f"{k['name']} never launched")
    print(f"whole run: {time.perf_counter() - t_start:.3f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def smoke_smem_bytes() -> dict:
    """Each planned kernel's largest dynamic shared memory at this
    script's own shapes (the kernel check covers the default config and
    each plan's largest admitted shape), from the plans that size it."""
    from repro_torch.configs import get_config
    from repro_torch.core import HoneycombConfig, NodeImageLayout
    from repro_torch.kernels import (delta_scatter, key_search, leaf_merge,
                                     paged_attention)
    cfg = HoneycombConfig()
    LW = NodeImageLayout.for_config(cfg).log_entry_words
    qwen = get_config("qwen2.5-3b")
    heads = [(qwen.n_heads, qwen.n_kv_heads, qwen.head_dim,
              SERVING_MAX_SEQ)] + [
        (H, KVH, D, SERVING_MAX_SEQ) for _, H, KVH, D, _, _ in PAGED_SHAPES]
    heads += [(c.n_heads, c.n_kv_heads, c.head_dim, MOE_SSM_MAX_SEQ)
              for c in map(get_config, ("olmoe-1b-7b", "jamba-v0.1-52b"))]
    heads += [(c.n_heads, c.n_kv_heads, c.head_dim, ENCDEC_SEQ)
              for c in (get_config(arch) for arch, _ in ENCDEC_MODELS)]
    B, P = SERVING_SLOTS, SERVING_PAGE
    return {
        "ops.key_search_image": max(key_search.image_plan(n, kw).smem_bytes
                                    for n, kw in WILD_IMAGE),
        "ops.key_search": max(key_search.block_plan(n, kw).smem_bytes
                              for n, kw in WILD_BLOCK),
        "ops.leaf_merge": max(leaf_merge.merge_plan(cfg.node_cap, x)
                              .smem_bytes for x in WILD_MERGE_LOGS),
        "ops.log_replay_scatter": max(delta_scatter.replay_plan(d, LW)
                                      .smem_bytes for d in REPLAY_CHECK_D
                                      + (REPLAY_TIMING_D,)),
        "ops.paged_attention": max(
            paged_attention.span_plan(B, H, KVH, L // P, P, D, dt).smem
            for H, KVH, D, L in heads
            for dt in (torch.bfloat16, torch.float32)),
    }


def kernel_check_phase(dev) -> None:
    """``python -m repro_torch.analysis``'s kernel check on the card: each
    entry point of ``kernels/ops.py`` once on small seeded inputs (these
    launches are no path's).  Each entry also gets its shared memory at
    this script's shapes (``smoke_smem_bytes``).  Prints one
    ``{"kernel_check": [...]}`` line; any finding fails the run."""
    from repro_torch.analysis import kernel_check
    findings, runs = kernel_check.run_kernel_checks(dev)
    for f in findings:
        print(f"  {f}")
    entries = kernel_check.summary(runs, findings, dev)
    smoke = smoke_smem_bytes()
    for e in entries:
        e["smoke_smem_bytes"] = smoke.get(e["name"], e["smem_bytes"])
    print(json.dumps({"kernel_check": entries}))
    check(not findings, f"the kernel check found {len(findings)} fault(s)")
    check(len(entries) == 10 and all(
        e["launches"] == 1 and e["other_launches"] == 0
        and e["readbacks"] <= e["readbacks_pinned"]
        and max(e["smem_bytes"], e["smoke_smem_bytes"]) <= e["smem_limit"]
        for e in entries), f"kernel check entries {entries}")


def single_shard_path(args, dev, flush):
    """The paper's deployment, one ``HoneycombStore``: load, read, write,
    delta-sync, read again; then the fused read and row-scatter kernels
    against their plain versions.  Returns their ``kernels`` entries and
    the path's launch counts."""
    from repro_torch.analysis import epochsan
    from repro_torch.core import HoneycombConfig, HoneycombStore
    from repro_torch.core.config import bucket_pow2
    from repro_torch.core.keys import int_key, pack_keys
    from repro_torch.kernels import build, delta_scatter, fused_read, ops, ref

    # ---- load the store (host tree only; no device work yet) -------------
    cfg = HoneycombConfig()
    rng = np.random.default_rng(args.seed)
    n = 1 << args.keys_log2
    store = HoneycombStore(cfg, device="cuda")
    model: dict[bytes, bytes] = {}
    order = rng.permutation(n)
    t0 = time.perf_counter()
    for i in order:
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
    # (EpochSan on, strict: every staging, flip and read batch passes its
    # seams; it stays off in the timed loops below)
    with epochsan.enabled() as san:
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
        for j, op in enumerate(rng.choice(3, args.writes,
                                          p=[0.6, 0.2, 0.2])):
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
    epochsan_report("single_shard", san, ("read_checks", "stagings",
                                          "flips"))

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
        # outputs, over the memory rate; the rows the kernel marks and its
        # dependent row reads a request must equal the plain walk's
        rows_read, loads = [], []
        for x in xs:
            marks = [(torch.zeros(S + C, dtype=torch.int32, device=dev),
                      torch.zeros(BATCH, dtype=torch.int32, device=dev))
                     for _ in range(2)]
            kfn(snap, *x, cfg=cfg, touched=marks[0][0], loads=marks[0][1])
            pfn(snap, *x, cfg=cfg, touched=marks[1][0], loads=marks[1][1])
            check(all(torch.equal(a, b) for a, b in zip(*marks)),
                  f"{name}: the rows read or the dependent row reads differ "
                  f"from the plain walk's")
            rows_read.append(int(marks[0][0].sum()))
            loads.append(marks[0][1])
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
        # the latency of one request's chain alone: batches of 2
        pair_ms = device_ms([lambda x=x: kfn(snap, *(t[:2].contiguous()
                                                    for t in x), cfg=cfg)
                             for x in xs], 64, "fused_read_kernel", flush)
        wrapper_ms = cuda_ms(calls, 200)
        plain_ms = cuda_ms(plain, 16)
        # the latency bound: the longest request's chain of dependent row
        # reads, each one round trip to device memory
        chain = int(loads.max())
        print(f"{name}: equals its plain version exactly (tolerance 0) at "
              f"lb_fraction 0.0 and 0.25, rows read and dependent row reads "
              f"included; kernel {ms:.4f} ms device time per "
              f"batch of {BATCH} (L2 flushed; before the redesign "
              f"{BEFORE_MS[name]:.4f} ms), {wrapper_ms:.4f} ms per call "
              f"through the wrapper back to back (plain {plain_ms:.4f} ms), "
              f"byte bound {bound_ms:.6f} ms from "
              f"{statistics.mean(rows_read):.1f} distinct rows per batch; "
              f"dependent row reads per request mean "
              f"{float(loads.mean()):.3f}, max {chain} (latency bound "
              f"{chain} round trips): {ms / max(chain, 1) * 1e3:.3f} us of "
              f"kernel time per dependent row read of the longest chain; a "
              f"batch of 2 takes {pair_ms:.4f} ms")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_read.cu",
            "replaces": line, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "pair_ms": pair_ms,
            "row_reads_mean": float(loads.mean()), "row_reads_max": chain})

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
    # the design's fixed cost: the same launch where every row repeats the
    # first (one row copied, the other blocks skip theirs); and a
    # contiguous copy of the d distinct rows, the card's own copy of the
    # same bytes
    floor_ms = device_ms(
        [lambda c=c: delta_scatter.snapshot_image_scatter(
            work, c[0][:1].expand(D).contiguous(),
            c[1][:1].expand(D, IW).contiguous()) for c in cases], 64,
        "row_scatter_kernel", flush)
    src = cases[0][1][:d].contiguous()
    copy = torch.empty_like(src)
    copy_ms = device_all_ms([lambda: copy.copy_(src)], 64, flush)
    wrapper_ms = cuda_ms(calls, 200)
    plain_ms = cuda_ms([lambda c=c: ref.snapshot_image_scatter_ref(
        work, c[0], c[1]) for c in cases], 50)
    library_ms = device_ms([lambda c=c: lib_img.index_copy_(0, c[2], c[1])
                            for c in cases], 64, "index_copy", flush)

    clone_ms = image_clone_ms(snap.image)
    bound_ms = scatter_bound_ms(d, IW, D)
    plan = delta_scatter.scatter_plan((IW,), D)
    print(f"row_scatter: equals its plain version and index_copy_ exactly "
          f"(tolerance 0); kernel {ms:.4f} ms device time for {D} rows ({d} "
          f"distinct) of {IW} words (L2 flushed; {plan.grid} blocks of "
          f"{plan.threads} threads, K = {plan.k}), {wrapper_ms:.4f} ms per "
          f"call through the wrapper back to back (plain {plain_ms:.4f} ms, "
          f"index_copy_ {library_ms:.4f} ms device time), bound "
          f"{bound_ms:.6f} ms; the per-delta image clone ({S * IW * 4} B "
          f"each way) takes {clone_ms:.4f} ms per clone (CUDA events over "
          f"32 back to back)")
    print(f"  row_scatter: the same launch copying one row (every row a "
          f"repeat of the first) {floor_ms:.4f} ms; a contiguous copy_ of "
          f"the {d} distinct rows ({d * IW * 4} B) {copy_ms:.4f} ms")
    kernels.append({
        "name": "row_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_scatter.cu",
        "replaces": "src/repro/kernels/delta_scatter.py:54",
        "launches": launches["row_scatter"], "max_abs_err": err, "ms": ms,
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms, "D": D,
        "floor_ms": floor_ms, "copy_ms": copy_ms})

    # ---- a read of an unflipped standby raises at its seam, before any
    # launch (a fresh strict sanitizer; after the timings, not counted)
    k = min(model)
    with epochsan.enabled() as probe:
        store.update(k, model[k])
        store.begin_export()                  # a delta staged, not flipped
        before = dict(build.LAUNCHES)
        try:
            store._device_get(store._standby, [k])
            kind = None
        except epochsan.EpochSanViolation as e:
            kind = e.kind
        unchanged = build.LAUNCHES == before
        check(kind == epochsan.STANDBY_READ and unchanged,
              f"a GET of the unflipped standby: violation {kind}, launches "
              f"{'unchanged' if unchanged else 'changed'}")
        store.flip()
        check(store.get_batch([k]) == [model[k]], "GET after the flip")
    print(json.dumps({"epochsan_standby_read": {
        "raised": kind, "launches_unchanged": unchanged,
        "violations": probe.stats.violations}}))
    # what the sanitizer adds to a read batch's host time: one read check
    # with the store registered, and one seam's test when it is off
    check(epochsan.get() is None, "EpochSan left on after the path")
    live, reps = store._snapshot, 10000
    t0 = time.perf_counter()
    for _ in range(reps):
        probe.check_read(store, live)
    check_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        epochsan.get()
    off_us = (time.perf_counter() - t0) / reps * 1e6
    print(f"EpochSan host cost (host clock, {reps} calls each): a read "
          f"check {check_us:.3f} us, a seam's test with the sanitizer off "
          f"{off_us:.3f} us, against a GET batch's host-clock median of "
          f"{statistics.median(lat1['get'] + lat2['get']) * 1e3:.3f} ms")
    # what the CPU baseline's phase replays: the load order, the writes,
    # the model after them and the reads made after them
    replay = {"store": store, "order": order, "writes": writes,
              "model": model, "gets": [keys for keys, _ in gets2],
              "scans": [ranges for ranges, _ in scans2], "load_s": load_s,
              "write_s": write_s}
    return kernels, launches, (snap, [keys for keys, _ in gets2]), replay


def ksu_rsu_path(args, dev, flush, snap, batches):
    """The paper's two hardware units through their own entry points,
    over the single-shard path's last snapshot (``--keys-log2`` keys after
    its writes and delta sync).  Each of the path's GET batches walks the
    levels the read path descends (``core/read_path.py:descend``); at
    every level the visited image rows are searched by the KSU three ways:
    ``key_search_image`` over the shortcut block and over the whole sorted
    block, and ``key_search`` over that sorted block decoded to separate
    operands.  Then ``leaf_merge`` (the RSU) orders every leaf row of the
    image.  Every result must equal its plain version, the read path's own
    shortcut floor, two-stage segment floor and leaf ranks; then each
    kernel is timed.  These entry points pass no EpochSan seam: no store
    path calls them.  Returns the three ``kernels`` entries and the path's
    launch counts."""
    from repro_torch.core import HoneycombConfig, NodeImageLayout
    from repro_torch.core import read_path as rp
    from repro_torch.core.heap import LEAF
    from repro_torch.core.keys import pack_keys
    from repro_torch.kernels import build, key_search, leaf_merge, ops, ref

    cfg = HoneycombConfig()
    N, L, KW, NSC = cfg.node_cap, cfg.log_cap, cfg.key_words, cfg.n_shortcuts
    offs = NodeImageLayout.for_config(cfg).offsets()
    view = rp.snapshot_fields(snap, cfg)
    image = snap.image

    def block(keys, lens, count, n):
        return dict(keys_off=offs[keys][0], lens_off=offs[lens][0],
                    count_off=offs[count][0], n_keys=n, key_words=KW)
    shortcut = block("sc_keys", "sc_keylen", "n_shortcuts", NSC)
    sorted_block = block("skeys", "skeylen", "nitems", N)

    def field(rows, name):
        o, w = offs[name]
        return rows[:, o:o + w].contiguous()

    def decoded(rows):
        """The sorted block of each row as key_search's operands."""
        B = rows.shape[0]
        valid = (torch.arange(N, dtype=torch.int32, device=dev)[None, :]
                 < rows[:, offs["nitems"][0]][:, None]).to(torch.int32)
        return (field(rows, "skeys").view(B, N, KW), field(rows, "skeylen"),
                valid)

    err = collections.Counter()       # max abs err of each kernel vs plain
    stats = collections.Counter()

    def same(name, want, got, what):
        e = max_abs_err([want], [got])
        check(e == 0 and want.dtype == got.dtype,
              f"{name}: {what} (max abs err {e})")
        err[name] = max(err[name], e)

    kept = []                         # leaf-level inputs, for the timings
    # ---- the main path, every launch count set to 0 just before it -------
    build.reset_launches()
    t0 = time.perf_counter()
    for keys in batches:
        lanes, lens = pack_keys(keys, KW)
        key = torch.from_numpy(lanes.view(np.int32)).to(dev)
        klen = torch.from_numpy(lens).to(dev)
        B = len(keys)
        lid = torch.full((B,), snap.root_lid, dtype=torch.int32,
                         device=dev)
        phys = torch.zeros_like(lid)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for level in range(cfg.max_height):
            cur = rp._resolve_version(view, view.pagetable[lid],
                                      snap.read_version, cfg)
            cur = torch.where(done, phys, cur)
            rows = image[cur]
            sc = ops.key_search_image(key, klen, rows, **shortcut)
            sb = ops.key_search_image(key, klen, rows, **sorted_block)
            blk = decoded(rows)
            bs = ops.key_search(key, klen, *blk)
            # (a) each kernel against its plain version on its inputs
            same("key_search_image", ref.key_search_image_ref(
                key, klen, rows, **shortcut), sc,
                "shortcut block vs plain")
            same("key_search_image", ref.key_search_image_ref(
                key, klen, rows, **sorted_block), sb,
                "sorted block vs plain")
            same("key_search", ref.key_search_ref(key, klen, *blk), bs,
                 "vs plain")
            # (b) the shortcut floor, (c) the two-stage segment floor,
            # (d) the block mode against the image mode, at this level
            seg = rp._shortcut_floor(view, cur, key, klen)
            check(torch.equal(sc.clamp(min=0), seg),
                  f"level {level}: shortcut search differs from the read "
                  f"path's _shortcut_floor")
            check(torch.equal(sb, rp._segment_floor(view, cur, seg, key,
                                                    klen, cfg)),
                  f"level {level}: sorted-block search differs from the "
                  f"read path's two-stage floor")
            check(torch.equal(bs, sb), f"level {level}: key_search "
                  f"differs from key_search_image on the decoded block")
            stats["visits"] += B
            stats["levels"] += 1
            stats["sorted_minus1"] += int((sb < 0).sum())
            stats["sorted_nonzero"] += int((sb != 0).sum())
            is_leaf = view.ntype[cur] == LEAF
            child = rp._child(view, cur, key, klen, cfg)
            done_next = done | is_leaf
            lid = torch.where(done_next, lid, child)
            phys, done = cur, done_next
            if bool(done.all()):
                break
        check(bool(done.all()), "a request found no leaf")
        if len(kept) < ROTATE:
            kept.append((key, klen, rows, blk))
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    leaf_rows = (view.ntype == LEAF).nonzero()[:, 0].to(torch.int32)
    leaves = image[leaf_rows]
    merge_in = (field(leaves, "nitems")[:, 0].contiguous(),
                field(leaves, "nlog")[:, 0].contiguous(),
                field(leaves, "log_backptr"), field(leaves, "log_hint"))
    perm, valid = ops.leaf_merge(*merge_in, node_cap=N, log_cap=L)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    # ---- counts and the merge's checks ------------------------------------
    check(launches["key_search_image"] == 2 * stats["levels"]
          and launches["key_search"] == stats["levels"]
          and launches["leaf_merge"] == 1,
          f"launches {launches} for {stats['levels']} batch levels")
    check(all(v == 0 for k, v in launches.items() if k not in
              ("key_search", "key_search_image", "leaf_merge")),
          f"the KSU/RSU path launched another kernel: {launches}")
    wp, wv = ref.leaf_merge_ref(*merge_in, node_cap=N, log_cap=L)
    same("leaf_merge", wp, perm, "perm vs plain")
    same("leaf_merge", wv, valid, "valid vs plain")
    # (e) the read path's own leaf ranks, stably sorted, in all T positions
    rank, used = rp.leaf_ranks(view.nitems[leaf_rows], view.nlog[leaf_rows],
                               view.log_backptr[leaf_rows],
                               view.log_hint[leaf_rows], N, L)
    check(torch.equal(perm, torch.argsort(rank, dim=1, stable=True)
                      .to(torch.int32)) and torch.equal(
                          valid, used.to(torch.int32)),
          "leaf_merge differs from the read path's leaf ranks")
    # (f) the inputs are not trivial
    n_leaves = leaf_rows.numel()
    with_log = int((merge_in[1] > 0).sum())
    check(with_log > 0 and stats["sorted_nonzero"] > 0,
          f"trivial inputs: {with_log} leaves with log entries, "
          f"{stats['sorted_nonzero']} non-zero sorted-block floors")
    print(f"checked {stats['visits']} node visits ({len(batches)} GET "
          f"batches of {BATCH}, {stats['levels']} batch levels): shortcut "
          f"search == _shortcut_floor, sorted-block search == the two-stage "
          f"floor ({stats['sorted_minus1']} below every key, "
          f"{stats['sorted_nonzero']} non-zero), key_search == "
          f"key_search_image, each == its plain version; {search_s:.3f} s "
          f"host clock with the checks")
    print(f"checked leaf_merge over {n_leaves} leaf rows ({with_log} with "
          f"log entries, {int(merge_in[1].sum())} entries in all): perm and "
          f"valid == plain and == the read path's leaf ranks stably sorted, "
          f"in all {N + L} positions; {merge_s * 1e3:.3f} ms host clock")
    print(f"  launches {launches}")

    # (g) the image mode at a block that needs the chunk loop and at key
    # widths of the generic instance, on synthetic rows (not counted)
    gen = torch.Generator(device="cpu").manual_seed(args.seed + 5)
    wild = []
    for n, kw in WILD_IMAGE:
        q, qlen, rows, mode = (x.to(dev) if torch.is_tensor(x) else x
                               for x in wild_image_rows(BATCH, n, kw, gen))
        same("key_search_image", ref.key_search_image_ref(
            q, qlen, rows, **mode), key_search.key_search_image(
                q, qlen, rows, **mode), f"{n} keys of {kw} lanes vs plain")
        wild.append(f"{n}x{kw} in {key_search.image_plan(n, kw).chunks} "
                    f"chunk(s)")
    check(any(key_search.image_plan(n, kw).chunks > 1
              for n, kw in WILD_IMAGE), "no synthetic block takes chunks")
    print(f"key_search_image on synthetic rows (lanes over the whole u32 "
          f"range, ties decided by length, counts of 0, above n_keys and "
          f"negative): {', '.join(wild)}; each == its plain version")

    # (h) the block mode on synthetic operands: the stores' width and
    # those of the generic instance, a block in two chunks, a key too wide
    # for one candidate (passes of lanes), valid masks all zero, full and
    # not a prefix; each also with its keys at a 4-byte offset (not
    # counted)
    wild = []
    for n, kw in WILD_BLOCK:
        args_ = [x.to(dev) for x in wild_block_operands(BATCH, n, kw, gen)]
        want = ref.key_search_ref(*args_)
        for keys in (args_[2], offset_view(args_[2])):
            same("key_search", want, key_search.key_search(
                args_[0], args_[1], keys, *args_[3:]),
                f"{n} keys of {kw} lanes at byte {keys.data_ptr() % 16} of "
                f"16 vs plain")
        plan = key_search.block_plan(n, kw)
        wild.append(f"{n}x{kw} ({plan.chunks} chunk(s) of {plan.spans} "
                    f"pass(es))")
    check(any(key_search.block_plan(n, kw).spans > 1
              for n, kw in WILD_BLOCK)
          and any(key_search.block_plan(n, kw).chunks > 1
                  for n, kw in WILD_BLOCK), "no synthetic block takes "
          "chunks or passes")
    print(f"key_search on synthetic operands (lanes over the whole u32 "
          f"range, ties decided by length, valid masks all zero, full and "
          f"not a prefix), each aligned and at a 4-byte offset: "
          f"{', '.join(wild)}; each == its plain version")
    # (i) the merge on wild leaves: both instances (a half-warp a leaf,
    # the generic one), a live rank of INT32_MAX, one equal to a sorted
    # rank, two log ranks equal, ranks that wrap, counts past the caps and
    # negative (not counted)
    for L_ in WILD_MERGE_LOGS:
        args_ = [x.to(dev) for x in wild_leaves(BATCH, N, L_, gen)]
        got = leaf_merge.leaf_merge(*args_, node_cap=N, log_cap=L_)
        want = ref.leaf_merge_ref(*args_, node_cap=N, log_cap=L_)
        same("leaf_merge", want[0], got[0], f"wild perm at L = {L_}")
        same("leaf_merge", want[1], got[1], f"wild valid at L = {L_}")
    print(f"leaf_merge on {BATCH} wild leaves of {N} sorted slots and "
          f"{', '.join(map(str, WILD_MERGE_LOGS))} log slots (instances "
          f"{sorted({leaf_merge.merge_plan(N, x).group for x in WILD_MERGE_LOGS})}"
          f" lanes a leaf, 0 the generic one): perm and valid == plain")

    # ---- timings at the path's shapes (these launches are not counted) ---
    def image_bytes(mode):
        """Bytes an image-mode search of the timed batches must move, per
        call: each request's query, length, count word and answer, and the
        lanes and length of each of its live candidates."""
        live = sum(int(c[2][:, mode["count_off"]].clamp(0, mode["n_keys"])
                       .sum()) for c in kept)
        return BATCH * (KW + 3) * 4 + live * (KW + 1) * 4 / len(kept)

    def block_bytes():
        """The same for block mode: the whole valid mask, then the lanes
        and length of each valid candidate."""
        live = sum(int(c[3][2].sum()) for c in kept)
        return BATCH * (KW + 2 + N) * 4 + live * (KW + 1) * 4 / len(kept)

    out = []
    for name, mode, match, line in (
            ("key_search_image", sorted_block, "key_search_image_kernel",
             "src/repro/kernels/key_search.py:88"),
            ("key_search", None, "key_search_kernel",
             "src/repro/kernels/key_search.py:131")):
        if mode is None:
            calls = [lambda c=c: key_search.key_search(c[0], c[1], *c[3])
                     for c in kept]
            plain = [lambda c=c: ref.key_search_ref(c[0], c[1], *c[3])
                     for c in kept]
            io = block_bytes()
        else:
            calls = [lambda c=c: key_search.key_search_image(
                c[0], c[1], c[2], **mode) for c in kept]
            plain = [lambda c=c: ref.key_search_image_ref(
                c[0], c[1], c[2], **mode) for c in kept]
            io = image_bytes(mode)
        # two turns for the kernel redesigned last (block mode)
        turns = [device_ms(calls, 64, match, flush)
                 for _ in range(1 if mode else 2)]
        ms = statistics.fmean(turns)
        wrapper_ms = cuda_ms(calls, 200)
        plain_ms = cuda_ms(plain, 32)
        bound_ms = io / HBM_BYTES_PER_S * 1e3
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/key_search.cu",
                 "replaces": line, "launches": launches[name],
                 "max_abs_err": err[name], "ms": ms,
                 "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": "bytes",
                 "library_ms": None, "B": BATCH}
        what = "sorted block decoded to operands" if mode is None \
            else "sorted block in the image rows"
        if mode is None:
            entry["ms_turns"] = turns
            plan = key_search.block_plan(N, KW)
            what += (f" ({plan.warps} warp(s) a block; turns "
                     f"{', '.join(f'{t:.6f}' for t in turns)}; before the "
                     f"redesign {BEFORE_MS[name]:.4f} ms)")
        if mode is not None:      # the same kernel on the shortcut block
            sc_calls = [lambda c=c: key_search.key_search_image(
                c[0], c[1], c[2], **shortcut) for c in kept]
            entry["ms_shortcut"] = device_ms(sc_calls, 64, match, flush)
            entry["bound_ms_shortcut"] = image_bytes(shortcut) \
                / HBM_BYTES_PER_S * 1e3
            what += (f"; shortcut block {entry['ms_shortcut']:.4f} ms, bound "
                     f"{entry['bound_ms_shortcut']:.6f} ms")
        print(f"{name}: equals its plain version exactly (tolerance 0); "
              f"kernel {ms:.4f} ms device time per batch of {BATCH} "
              f"(L2 flushed), {wrapper_ms:.4f} ms per call through the "
              f"wrapper back to back (plain {plain_ms:.4f} ms), bound "
              f"{bound_ms:.6f} ms ({io:.0f} B), {what}; no single PyTorch "
              f"call computes this floor")
        out.append(entry)

    calls = [lambda: leaf_merge.leaf_merge(*merge_in, node_cap=N,
                                           log_cap=L)]
    turns = [device_ms(calls, 64, "leaf_merge_kernel", flush)
             for _ in range(2)]
    ms = statistics.fmean(turns)
    wrapper_ms = cuda_ms(calls, 200)
    plain_ms = cuda_ms([lambda: ref.leaf_merge_ref(
        *merge_in, node_cap=N, log_cap=L)], 16)
    argsort_ms = device_all_ms(
        [lambda: torch.argsort(rank, dim=1, stable=True)], 64, flush)
    # nitems, nlog and both outputs of every leaf, and the back pointer and
    # hint of each live log entry
    io = n_leaves * 4 * (2 + 2 * (N + L)) \
        + 8 * int(merge_in[1].clamp(0, L).sum())
    bound_ms = io / HBM_BYTES_PER_S * 1e3
    plan = leaf_merge.merge_plan(N, L)
    print(f"leaf_merge: equals its plain version exactly (tolerance 0); "
          f"kernel {ms:.4f} ms device time for {n_leaves} leaves (L2 "
          f"flushed), {wrapper_ms:.4f} ms per call through the wrapper back "
          f"to back (plain {plain_ms:.4f} ms), bound {bound_ms:.6f} ms ({io} "
          f"B); partial yardstick torch.argsort(stable=True) of the "
          f"precomputed ranks (no shift-register sort, no ranks) "
          f"{argsort_ms:.4f} ms device time; turns "
          f"{', '.join(f'{t:.6f}' for t in turns)}, {plan.group} lanes a "
          f"leaf, {plan.warps} warps a block; before the redesign "
          f"{BEFORE_MS['leaf_merge']:.4f} ms")
    out.append({"name": "leaf_merge", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/leaf_merge.cu",
                "replaces": "src/repro/kernels/leaf_merge.py:85",
                "launches": launches["leaf_merge"],
                "max_abs_err": err["leaf_merge"], "ms": ms,
                "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": None, "argsort_ms": argsort_ms,
                "leaves": n_leaves, "ms_turns": turns})
    return out, launches


#: (n_keys, key_words) of the synthetic image-mode checks: the stores'
#: width with a block that needs two chunks, then widths of the kernel's
#: generic instance, one of them chunked
WILD_IMAGE = ((300, 8), (40, 3), (700, 3))


def wild_image_rows(B: int, N: int, KW: int, gen) -> tuple:
    """Synthetic image rows holding one candidate block (count word 2,
    keys from word 5, lengths after them): lanes over the whole u32 range,
    most candidates sharing their query's lanes up to a random lane (so
    high bits and ties decided by length both occur), counts of 0, above
    ``N``, with the top bit set and in between.  Returns (q, qlen, rows,
    the ``key_search_image`` keywords), on the CPU."""
    koff, loff, coff = 5, 5 + N * KW, 2
    word = dict(generator=gen, dtype=torch.int32)
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, loff + N + 7), **word)
    q = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, KW), **word)
    qlen = torch.randint(0, 4 * KW + 1, (B,), **word)
    keys = rows[:, koff:loff].view(B, N, KW)
    cut = torch.randint(0, KW + 1, (B, N, 1), generator=gen)
    share = (torch.arange(KW) < cut) \
        & (torch.rand(B, N, 1, generator=gen) < 0.7)
    keys.copy_(torch.where(share, q[:, None, :], keys))
    rows[:, loff:loff + N] = torch.randint(0, 4 * KW + 1, (B, N), **word)
    count = torch.randint(0, N + 1, (B,), **word)
    count[:4] = torch.tensor([0, N + 5, -2 ** 31 + 3, -1])
    rows[:, coff] = count
    return q, qlen, rows, dict(keys_off=koff, lens_off=loff, count_off=coff,
                               n_keys=N, key_words=KW)


# The synthetic cases below follow tests/test_torch_cuda.py's
# _block_case, _offset_view and _wild_merge_case.  They are copies, not
# imports: the smoke runs on the port alone, every module it imports
# coming from src/ (tests/test_torch_foundations.py holds that).
#: (n_keys, key_words) of the synthetic block-mode checks: the stores'
#: width (8) and others of the generic instance (1, 3, 12), a block in two
#: chunks (300 keys of 8 lanes) and a key too wide for one candidate beside
#: the query (passes of lanes)
WILD_BLOCK = ((3, 1), (64, 8), (80, 12), (300, 3), (300, 8), (40, 1500))
#: log slots of the synthetic leaf-merge checks: the register instance's
#: edges (1, 16) and the generic instance's (32, 33, 40)
WILD_MERGE_LOGS = (1, 16, 32, 33, 40)


def wild_block_operands(B: int, N: int, KW: int, gen) -> tuple:
    """Synthetic block-mode search operands: lanes over the whole u32
    range, most candidates sharing their query's lanes up to a random lane
    (so high bits and ties decided by length both occur); row 0's valid
    mask all zero, row 1's full, row 2's every other candidate, the rest
    random.  Returns (q, qlen, keys, klens, valid), on the CPU."""
    word = dict(generator=gen, dtype=torch.int32)
    q = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, KW), **word)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, N, KW), **word)
    cut = torch.randint(0, KW + 1, (B, N, 1), generator=gen)
    share = (torch.arange(KW) < cut) \
        & (torch.rand(B, N, 1, generator=gen) < 0.7)
    keys = torch.where(share, q[:, None, :], keys).contiguous()
    qlen = torch.randint(0, 4 * KW + 1, (B,), **word)
    klens = torch.randint(0, 4 * KW + 1, (B, N), **word)
    valid = (torch.rand(B, N, generator=gen) < 0.8).to(torch.int32)
    valid[0], valid[1], valid[2, ::2] = 0, 1, 0
    return q, qlen, keys, klens, valid


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous tensor of its shape that starts one
    element into a larger buffer: 4 bytes past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    check(view.is_contiguous() and view.data_ptr() % 16 == 4,
          "offset view not 4 bytes past a 16-byte boundary")
    return view


def wild_leaves(B: int, N: int, L: int, gen) -> tuple:
    """Synthetic leaves (B >= 3) of int32 words from the whole range:
    counts in [-3, cap + 4], back pointers and hints whose ranks wrap,
    half the rows' hints in [0, L]; leaf 0's one live log entry ranks
    INT32_MAX, leaf 1's equals a sorted item's rank, leaf 2's two live
    entries rank equal.  Returns (nitems, nlog, backptr, hints), on the
    CPU."""
    word = dict(generator=gen, dtype=torch.int32)
    nitems = torch.randint(-3, N + 4, (B,), **word)
    nlog = torch.randint(-3, L + 4, (B,), **word)
    backptr = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, L), **word)
    hints = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, L), **word)
    hints[::2] = hints[::2].remainder(L + 1)
    if L >= 1:
        nlog[0], backptr[0, 0], hints[0, 0] = 1, 0, 2 ** 31 - 1
    if L >= 1 and N >= 1:
        nlog[1], nitems[1] = 1, N
        backptr[1, 0], hints[1, 0] = min(2, N - 1), L
    if L >= 2:
        nlog[2] = 2
        backptr[2, :2] = torch.tensor([3, 2])
        hints[2, :2] = torch.tensor([0, L + 1])
    return nitems, nlog, backptr, hints


def replay_case(S: int, d: int, offs, layout, gen) -> tuple:
    """A log replay of ``d`` distinct records padded to a power of two with
    repeats of the last one, as the feed pads them: up to three entries
    per row at distinct slots, in shuffled order; row 7's old ``nlog``
    (set by the caller) lies above every new slot."""
    from repro_torch.core.config import bucket_pow2
    D = bucket_pow2(d)
    pool = torch.randperm(S - 8, generator=gen)[:(d + 2) // 3] + 8
    pool[0] = 7
    i = torch.arange(d)
    order = torch.randperm(d, generator=gen)
    rows = pool[i // 3][order].to(torch.int32)
    slots = (i % 3)[order].to(torch.int32)
    entries = torch.randint(-2 ** 31, 2 ** 31 - 1,
                            (d, layout.log_entry_words), generator=gen,
                            dtype=torch.int32)
    rows = torch.cat([rows, rows[-1:].expand(D - d)])
    slots = torch.cat([slots, slots[-1:].expand(D - d)])
    entries = torch.cat([entries, entries[-1:].expand(D - d, -1)])
    return rows, slots, entries


def baseline_path(dev, replay):
    """The paper's yardstick beside the store on the card's host: the
    port's ``CpuOrderedStore`` takes the single-shard path's load (same
    keys, same order) and its writes, then that path's GET and SCAN
    batches made after the writes go through both stores' ``get_batch``
    and ``scan_batch`` in turns (baseline batch, store batch, ...), with
    EpochSan off, on the host's clock.  Every answer of both must equal
    the dict model.  Then the live store dry run
    (``launch/store_dryrun.py``) at its defaults on ``dev``: its own
    assertions hold, and its sync, feed, cache and telemetry meters print
    a line each.  Returns the launch counts of the two store drives, each
    set to 0 just before it."""
    from repro_torch.analysis import epochsan
    from repro_torch.baselines import CpuOrderedStore
    from repro_torch.core.keys import int_key
    from repro_torch.kernels import build
    from repro_torch.launch import store_dryrun

    store, model = replay["store"], replay["model"]
    cfg = store.cfg
    cpu = CpuOrderedStore(node_cap=cfg.node_cap)
    order = replay["order"]
    t0 = time.perf_counter()
    for i in order:
        cpu.put(int_key(int(i)), value(int(i), 0))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for op, i, gen in replay["writes"]:
        k = int_key(i)
        if op == 0:
            cpu.update(k, value(i, gen))
        elif op == 1:
            cpu.delete(k)
        else:
            cpu.put(k + b"\x01", value(i, gen))
    write_s = time.perf_counter() - t0
    n, n_writes = len(order), len(replay["writes"])
    print(f"baseline load: {n} puts in {load_s:.3f} s ({n / load_s:.0f} "
          f"puts/s; the store's, host tree only, in the single-shard path: "
          f"{n / replay['load_s']:.0f} puts/s, not in turns); {n_writes} "
          f"writes in {write_s * 1e3:.3f} ms ({n_writes / write_s:.0f}/s; "
          f"the store's {n_writes / replay['write_s']:.0f}/s, not in "
          f"turns); {len(cpu.leaves)} leaves")

    # ---- GET and SCAN batches in turns, EpochSan off ----------------------
    check(epochsan.get() is None, "EpochSan on around the timed loop")
    gets, scans = replay["gets"], replay["scans"]
    secs = {(who, op): [] for who in ("baseline", "store")
            for op in ("get", "scan")}
    answers = {key: [] for key in secs}
    stores = {"baseline": cpu, "store": store}
    full_gcs = gc.get_stats()[2]["collections"]
    build.reset_launches()
    for op, batches in (("get", gets), ("scan", scans)):
        for batch in batches:
            for who in ("baseline", "store"):
                fn = getattr(stores[who], f"{op}_batch")
                t = time.perf_counter()
                got = fn(batch)
                secs[who, op].append(time.perf_counter() - t)
                answers[who, op].append(got)
    base_launches = dict(build.LAUNCHES)
    full_gcs = gc.get_stats()[2]["collections"] - full_gcs
    check(epochsan.get() is None, "EpochSan on around the timed loop")
    keys_sorted = sorted(model)
    for who in ("baseline", "store"):
        for keys, got in zip(gets, answers[who, "get"]):
            check(got == [model.get(k) for k in keys],
                  f"{who} GET batch differs from the model")
        for ranges, got in zip(scans, answers[who, "scan"]):
            check(got == [model_scan(keys_sorted, model, lo, hi)
                          for lo, hi in ranges],
                  f"{who} SCAN batch differs from the model")
    check(base_launches["fused_get"] == len(gets)
          and base_launches["fused_scan"] == len(scans),
          f"store launches in the baseline phase {base_launches}")
    print(f"checked {len(gets) * BATCH} GETs and {len(scans) * BATCH} SCANs "
          f"of each store against the model")
    rate = {}
    for op in ("get", "scan"):
        for who in ("baseline", "store"):
            xs = secs[who, op]
            rate[who, op] = len(xs) * BATCH / sum(xs)
            med = statistics.median(xs)
            print(f"  {who} {op.upper()}: {rate[who, op]:.0f} ops/s "
                  f"(batches of {BATCH} in turns, host clock; median batch "
                  f"{med * 1e3:.3f} ms, {BATCH / med:.0f} ops/s at the "
                  f"median; max {max(xs) * 1e3:.3f} ms in turn "
                  f"{xs.index(max(xs))})")
        print(f"  store / baseline {op.upper()} ops/s: "
              f"{rate['store', op] / rate['baseline', op]:.4f}")
    print(f"  the interpreter's full garbage collections during the timed "
          f"turns: {full_gcs}")
    print(f"  baseline {cpu.stats}")
    interior = cfg.header_bytes + cfg.shortcut_bytes + cfg.segment_bytes
    print(f"  byte model: node_bytes {cfg.node_bytes}, header + shortcut + "
          f"segment bytes {interior} per interior level")

    # ---- the live store dry run at its defaults ---------------------------
    build.reset_launches()
    for name in ("live_sharded_smoke", "live_replicated_smoke"):
        t0 = time.perf_counter()
        out = getattr(store_dryrun, name)(device=dev.type)
        took = time.perf_counter() - t0
        tel = out["telemetry"]
        rp = out["read_path"]
        check(rp["vmem_hits"] > 0 and rp["fused_matches_reference"],
              f"{name}: read path {rp}")
        sync = {k: out[k] for k in (
            "image_dma_count", "image_bytes", "per_shard_bytes_synced",
            "per_shard_delta_syncs", "dirty_shard_syncs_after_confined_burst",
            "log_wire_bytes", "load_imbalance", "primary_image_dmas",
            "primary_sync_bytes", "replication_bytes", "replica_lag_epochs",
            "replica_staleness", "lagging_skips") if k in out}
        if "pipelined_epoch" in out:
            sync["pipelined_epoch"] = out["pipelined_epoch"]
        print(json.dumps({name: {"seconds": took, "sync": sync}}))
        if "feed" in out:
            print(json.dumps({name: {"feed": out["feed"]}}))
        print(json.dumps({name: {"cache": rp}}))
        print(json.dumps({name: {"telemetry": {
            "metrics": len(tel["snapshot"]),
            "sampled_traces": tel["sampled_traces"],
            "last_trace": tel["last_trace"]}}}))
    live_launches = dict(build.LAUNCHES)
    check(live_launches["fused_get"] > 0 and live_launches["row_scatter"] > 0
          and live_launches["log_replay"] > 0,
          f"live smokes' launches {live_launches}")
    print(f"  live smokes' launches {live_launches}")
    return base_launches, live_launches


def replicated_path(args, dev, flush):
    """The range-sharded, replicated store on the log-shipped feed: 2
    shards x 3 replicas (``benchmarks/common.py:build_stores(shards=2,
    replicas=3, replica_policy="round_robin", feed="log")``).  Load, full
    export, update epochs (log-feed and natural fallback epochs), an
    insert epoch, a GC epoch, a paused follower's catch-up, with every
    follower image held against its primary after every flip and reads
    from every replica held against a dict model; then the log-replay
    kernel against its plain version, and the row scatter against its
    plain version at two of the path's fallback deltas.  Returns the
    log-replay ``kernels`` entry, the path's launch counts and the row
    scatter's comparison (its deltas' sizes and max abs err)."""
    from repro_torch.analysis import epochsan
    from repro_torch.core import (FeedTopology, HoneycombConfig,
                                  NodeImageLayout, ReplicationConfig,
                                  ShardedHoneycombStore,
                                  uniform_int_boundaries)
    from repro_torch.core.config import bucket_pow2
    from repro_torch.core.keys import int_key
    from repro_torch.core.read_path import attach_cache_image
    from repro_torch.kernels import build, delta_scatter, ops, ref

    cfg = HoneycombConfig()
    n = 1 << args.replicated_keys_log2
    boundary = n // 2
    rng = np.random.default_rng(args.seed + 1)
    store = ShardedHoneycombStore(
        cfg, shards=2, boundaries=uniform_int_boundaries(n, 2),
        replication=ReplicationConfig(
            replicas=3, policy="round_robin", feed="log",
            topology=FeedTopology(fanout=2, depth=0)),
        device="cuda")
    groups = store.shards
    model: dict[bytes, bytes] = {}
    t0 = time.perf_counter()
    for i in rng.permutation(n):
        k, v = int_key(int(i)), value(int(i), 0)
        store.put(k, v)
        model[k] = v
    load_s = time.perf_counter() - t0
    # the load's splits leave old node versions behind; reclaim them now so
    # that the GC epoch below frees only what the epochs left (a delta)
    load_freed = [g.collect_garbage() for g in groups]
    print(f"load: {n} puts in {load_s:.3f} s ({n / load_s:.0f} puts/s); "
          f"GC freed {load_freed} node slots; per shard height "
          f"{[g.tree.height for g in groups]}, heap capacity "
          f"{[g.tree.heap.capacity for g in groups]} rows")

    followers_checked = [0]

    def check_followers(what: str) -> None:
        """Every in-sync, unpaused follower that published the primary's
        epoch holds the primary's image and cache tier bit for bit."""
        for s, g in enumerate(groups):
            p = g.primary._snapshot
            for f in g.followers:
                if f.paused or not f.in_sync or f.epoch != g.primary.epoch:
                    continue
                check(f.snapshot_rv == g.primary._snapshot_rv
                      and torch.equal(f.snapshot.image, p.image)
                      and torch.equal(f.snapshot.cache_image, p.cache_image)
                      and torch.equal(f.snapshot.cache_lids, p.cache_lids),
                      f"{what}: shard {s} follower {f.replica_id} differs "
                      f"from its primary")
                followers_checked[0] += 1

    lat = {"get": [], "scan": []}
    n_reads = {"get": 0, "scan": 0, "straddling": 0}

    def read_phase(what: str, batches: int = 6) -> None:
        """GET batches (hits and misses) and SCAN batches of 8-key ranges,
        16 of each batch's ranges across the shard boundary, through the
        router's round-robin picks; every answer against the model."""
        keys_sorted = sorted(model)
        for _ in range(batches):
            keys = [int_key(int(x)) for x in
                    rng.integers(0, n + n // 4, BATCH)]
            t = time.perf_counter()
            got = store.get_batch(keys)
            lat["get"].append(time.perf_counter() - t)
            for k, a in zip(keys, got):
                check(a == model.get(k), f"{what}: GET {k!r}: {a!r}")
            los = [boundary - int(x) for x in
                   rng.integers(1, SCAN_ITEMS, 16)]
            los += [int(x) for x in rng.integers(0, n, BATCH - 16)]
            ranges = [(int_key(a), int_key(a + SCAN_ITEMS - 1)) for a in los]
            t = time.perf_counter()
            got = store.scan_batch(ranges)
            lat["scan"].append(time.perf_counter() - t)
            for (lo, hi), a in zip(ranges, got):
                check(a == model_scan(keys_sorted, model, lo, hi),
                      f"{what}: SCAN {lo!r}..{hi!r}")
            n_reads["get"] += BATCH
            n_reads["scan"] += BATCH
            n_reads["straddling"] += 16

    epochs = []            # (label, per-shard feed kind, host ms, D list)
    # fallback deltas kept to hold the row scatter against its plain
    # version after the main path: (label, shard, delta, follower image
    # before the delta, follower image after it)
    kept_deltas = []

    def epoch(label: str, keep_delta: bool = False) -> None:
        """One export of the writes made since the last one (staging, then
        flip); classify each shard's staging by the feed it took, and hold
        the follower log replays with entries it caused against the
        kernel's launches.  With ``keep_delta`` each fallback shard's
        staged delta is kept, with follower 1's images around it."""
        fs0 = [dataclasses.replace(g.feed_stats) for g in groups]
        st0 = [[dataclasses.replace(f.sync_stats) for f in g.followers]
               for g in groups]
        lr0 = build.LAUNCHES["log_replay"]
        t = time.perf_counter()
        store.begin_export()
        staged = [(g.primary.last_staged, g.followers[0].snapshot)
                  for g in groups]
        store.flip()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        kinds, sizes = [], []
        for s, (g, fs, sts) in enumerate(zip(groups, fs0, st0)):
            f1 = g.feed_stats
            kinds.append("log" if f1.log_feed_epochs > fs.log_feed_epochs
                         else "fallback"
                         if f1.log_fallback_epochs > fs.log_fallback_epochs
                         else "full" if f1.full_feed_epochs
                         > fs.full_feed_epochs else "clean")
            # a replay of zero entries (a forced, empty epoch) launches
            # nothing: count the replays whose entries grew
            for f, s0 in zip(g.followers, sts):
                grew = f.sync_stats.log_entries - s0.log_entries
                if f.sync_stats.log_replays > s0.log_replays and grew:
                    sizes.append(bucket_pow2(grew))
            payload, before = staged[s]
            if keep_delta and kinds[-1] == "fallback":
                check(payload.delta is not None,
                      f"{label}: shard {s} fell back without a delta")
                kept_deltas.append((label, s, payload.delta, before.image,
                                    g.followers[0].snapshot.image))
        check(build.LAUNCHES["log_replay"] - lr0 == len(sizes),
              f"{label}: {build.LAUNCHES['log_replay'] - lr0} log_replay "
              f"launches for {len(sizes)} follower log replays with entries")
        epochs.append((label, kinds, ms, sizes))
        check_followers(label)

    def update(i: int, gen: int) -> None:
        k, v = int_key(i), value(i, gen)
        store.update(k, v)
        model[k] = v

    # ---- the main path, every launch count set to 0 just before it -------
    # (EpochSan on, strict, over the epochs and their reads: the GC and
    # paused-follower epochs included; off in the timings below)
    with epochsan.enabled() as san:
        build.reset_launches()
        ops.reset_read_dispatches()
        t0 = time.perf_counter()
        store.export_snapshot()
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        check_followers("full export")
        imgs = [(g.primary._snapshot.image, [f.snapshot.image
                                             for f in g.followers])
                for g in groups]
        print(f"full export {full_s * 1e3:.3f} ms; resident images: "
              + "; ".join(f"shard {s}: {1 + len(fs)} x {tuple(p.shape)} "
                          f"({p.nbytes} B each)"
                          for s, (p, fs) in enumerate(imgs)))
        read_phase("after the load")
        gen = 1
        for e in range(EPOCHS):
            for i in rng.integers(0, n, EPOCH_WRITES):
                update(int(i), gen)
                gen += 1
            # keep the first fallback epoch's deltas (a few dirty leaves)
            epoch(f"update epoch {e}", keep_delta=not kept_deltas)
            if (e + 1) % 16 == 0:
                read_phase(f"after update epoch {e}", batches=2)
        per_shard = [[sum(1 for _, k, _, _ in epochs if k[s] == kind)
                      for kind in ("log", "fallback")] for s in range(2)]
        print(f"{EPOCHS} epochs of {EPOCH_WRITES} updates: per shard "
              f"[log-feed, fallback] epochs {per_shard}")
        for s, (n_log, _) in enumerate(per_shard):
            check(n_log >= 16, f"shard {s}: only {n_log} log-feed epochs")
        fb0 = [g.feed_stats.log_fallback_epochs for g in groups]
        for i in rng.integers(0, n, 200):            # splits: a fallback epoch
            k, v = int_key(int(i)) + b"\x01", value(int(i), gen)
            store.put(k, v)
            model[k] = v
            gen += 1
        epoch("insert epoch", keep_delta=True)
        print(f"insert epoch of 200 new keys fed {epochs[-1][1]}")
        check("fallback" in epochs[-1][1], f"insert epoch fed {epochs[-1][1]}")
        read_phase("after the insert epoch", batches=2)
        for i in rng.integers(0, n, EPOCH_WRITES):
            update(int(i), gen)
            gen += 1
        freed = [g.collect_garbage() for g in groups]
        epoch("GC epoch")
        print(f"GC epoch: {freed} node slots freed per shard, fed "
              f"{epochs[-1][1]}")
        check(sum(freed) > 0, "GC freed nothing")
        for s, (nf, kind) in enumerate(zip(freed, epochs[-1][1])):
            check(kind != "log" or not nf, f"GC epoch on shard {s} fed {kind}")
        read_phase("after the GC epoch", batches=2)
        g0 = groups[0]
        g0.pause_follower(2)
        for i in rng.integers(0, boundary, EPOCH_WRITES):   # shard 0
            update(int(i), gen)
            gen += 1
        epoch("paused epoch")
        check(g0.replica_lag_epochs[1] >= 1
              and 2 not in g0.eligible_replicas(),
              f"paused follower lag {g0.replica_lag_epochs}")
        read_phase("with a paused follower", batches=2)
        g0.resume_follower(2)
        catch0 = g0.feed_stats.full_catchups
        for i in rng.integers(0, boundary, EPOCH_WRITES):
            update(int(i), gen)
            gen += 1
        epoch("catch-up epoch")
        check(g0.feed_stats.full_catchups == catch0 + 1
              and g0.replica_lag_epochs == [0, 0],
              f"catch-up: {g0.feed_stats}, lag {g0.replica_lag_epochs}")
        read_phase("after the catch-up", batches=4)
        launches = dict(build.LAUNCHES)
        dispatches = ops.read_dispatch_stats()
    epochsan_report("replicated", san, ("read_checks", "stagings", "flips",
                                        "gc_audits", "dispatch_checks"))

    # ---- counts ----------------------------------------------------------
    fol = [f for g in groups for f in g.followers]
    replays = sum(f.sync_stats.log_replays for f in fol)
    replays_with_entries = sum(len(ds) for _, _, _, ds in epochs)
    applies = sum(s.delta_syncs for g in groups
                  for s in g.per_replica_sync_stats)
    check(launches["log_replay"] == replays_with_entries,
          f"log_replay launches {launches} vs {replays_with_entries} "
          f"follower replays with entries")
    check(launches["row_scatter"] == applies,
          f"row_scatter launches {launches} vs {applies} delta applies")
    check(launches["fused_get"] == dispatches["get_fused"]["batches"]
          and launches["fused_scan"] == dispatches["scan_fused"]["batches"],
          f"fused launches {launches} vs read dispatches {dispatches}")

    # ---- the row scatter against its plain version, at this path's deltas -
    # (after the counts were read: these launches are not the main path's)
    check(any(label == "insert epoch" for label, *_ in kept_deltas)
          and any(label != "insert epoch" for label, *_ in kept_deltas),
          f"kept fallback deltas {[x[:2] for x in kept_deltas]}")
    scatter = {"D": [], "max_abs_err": 0}
    for label, s, delta, before, after in kept_deltas:
        want = ref.snapshot_image_scatter_ref(before.clone(), delta.rows,
                                              delta.image)
        got = delta_scatter.snapshot_image_scatter(before.clone(),
                                                   delta.rows, delta.image)
        e = max_abs_err([want, want], [got, after])
        check(e == 0, f"row_scatter on the {label}'s shard {s} delta "
              f"(D={delta.rows.numel()}): kernel, plain version and the "
              f"follower's published image differ (max abs err {e})")
        scatter["D"].append(delta.rows.numel())
        scatter["max_abs_err"] = max(scatter["max_abs_err"], e)
    print(f"row_scatter on the replicated path's fallback deltas "
          f"({', '.join(f'{label} shard {s}' for label, s, *_ in kept_deltas)}"
          f"): D = {scatter['D']}; kernel equals its plain version and the "
          f"follower's published image exactly (tolerance 0)")
    del kept_deltas[:]
    ops_by = store.per_shard_replica_ops
    check(all(r > 0 for o in ops_by for r in o),
          f"round robin left a replica idle: {ops_by}")
    print(f"checked {n_reads['get']} GETs and {n_reads['scan']} SCANs "
          f"({n_reads['straddling']} across the shard boundary) against the "
          f"model; {followers_checked[0]} follower flips bit-identical to "
          f"their primary")
    print(f"  launches {launches}; read dispatches {dispatches}")
    print(f"  requests served per replica (primary first), per shard "
          f"{ops_by}; lagging skips {store.lagging_skips}")
    for s, g in enumerate(groups):
        print(f"  shard {s} {g.feed_stats}")
        print(f"  shard {s} follower SyncStats "
              f"{[f.sync_stats for f in g.followers]}")
    fs = store.feed_stats
    n_fallback_applies = sum(f.sync_stats.delta_syncs for f in fol)
    print(f"  feed bytes per follower per epoch: log "
          f"{fs.log_bytes / max(replays, 1):.1f} B over {replays} "
          f"replays, fallback {fs.fallback_bytes / max(n_fallback_applies, 1):.1f}"
          f" B over {n_fallback_applies} delta applies, catch-up "
          f"{fs.catchup_bytes} B over {fs.full_catchups}")
    # an epoch is a fallback epoch when any shard fell back, else a log
    # epoch when every staged shard replayed its log
    for kind, xs in (("log", [ms for _, k, ms, _ in epochs
                              if "log" in k and "fallback" not in k]),
                     ("fallback", [ms for _, k, ms, _ in epochs
                                   if "fallback" in k])):
        print(f"  sync (export_snapshot, host clock) of a {kind} epoch: "
              f"median {statistics.median(xs):.3f} ms, max {max(xs):.3f} "
              f"ms over {len(xs)} epochs")
    for op in ("get", "scan"):
        xs = sorted(lat[op])
        print(f"  {op} batch of {BATCH} through the router (round robin, "
              f"host clock): median {statistics.median(xs) * 1e3:.3f} ms")

    # ---- reads pinned to the primary vs to a follower ---------------------
    keys = [[int_key(int(x)) for x in rng.integers(0, n, BATCH)]
            for _ in range(8)]
    ranges = [[(int_key(int(a)), int_key(int(a) + SCAN_ITEMS - 1))
               for a in rng.integers(0, n, BATCH)] for _ in range(8)]
    keys_sorted = sorted(model)
    for r in (0, 1, 2):
        ts = {"get": [], "scan": []}
        for ks, rs in zip(keys, ranges):
            t = time.perf_counter()
            got = store.get_batch(ks, replica=r)
            ts["get"].append(time.perf_counter() - t)
            check(got == [model.get(k) for k in ks]
                  and all(g.last_dispatch[0] == r for g in groups),
                  f"GET pinned to replica {r}")
            t = time.perf_counter()
            got = store.scan_batch(rs, replica=r)
            ts["scan"].append(time.perf_counter() - t)
            check(got == [model_scan(keys_sorted, model, lo, hi)
                          for lo, hi in rs], f"SCAN pinned to replica {r}")
        print(f"  replica {r} ({'primary' if r == 0 else 'follower'}): GET "
              f"batch median {statistics.median(ts['get']) * 1e3:.3f} ms, "
              f"SCAN batch median {statistics.median(ts['scan']) * 1e3:.3f} "
              f"ms (host clock, 8 batches each)")

    # ---- where one log epoch's time goes ---------------------------------
    # shard 0 only, a few updates, until its staging replays the log; the
    # staging (primary delta apply, then each follower's clone, replay and
    # cache re-attach) is traced, then the host marshal and one cache
    # re-attach are timed alone on the staged payload
    for attempt in range(10):
        for i in rng.integers(0, boundary, 2):
            update(int(i), gen)
            gen += 1
        n_log = g0.feed_stats.log_feed_epochs
        events = device_events(g0.begin_export)[0]
        if g0.feed_stats.log_feed_epochs > n_log:
            break
        g0.flip()
    lp = g0.primary.last_staged.log_payload
    if lp is None:
        print("log epoch breakdown: no log epoch in 10 tries")
    else:
        t = time.perf_counter()
        g0._marshal_log_payload(lp)
        torch.cuda.synchronize()
        marshal_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        attach_cache_image(g0.followers[0]._standby, cfg)
        torch.cuda.synchronize()
        attach_ms = (time.perf_counter() - t) * 1e3
        busy_us = sum(u for _, u in events)
        print(f"log epoch breakdown (shard 0, {lp.entries} entries, 2 "
              f"followers): {busy_us:.1f} us of device activity in the "
              f"traced staging; host marshal of the payload alone "
              f"{marshal_ms:.3f} ms, one follower cache re-attach alone "
              f"{attach_ms:.3f} ms (host clock, synchronized)")
        print_activities(events, "log epoch staging", top=8)
    g0.flip()
    check_followers("the traced epoch")

    # ---- the log-replay kernel against its plain version -----------------
    layout = NodeImageLayout.for_config(cfg)
    offs = layout.log_replay_offsets()
    base = groups[0].followers[0].snapshot.image
    S, IW = base.shape
    gen_t = torch.Generator(device="cpu").manual_seed(args.seed)
    err, sizes = 0, []
    for d in REPLAY_CHECK_D:
        rows, slots, entries = (x.to(dev) for x in
                                replay_case(S, d, offs, layout, gen_t))
        img = base.clone()
        img[7, offs.nlog] = offs.log_cap
        want = ref.log_replay_scatter_ref(img.clone(), rows, slots, entries,
                                          offs=offs)
        got = delta_scatter.log_replay_scatter(img, rows, slots, entries,
                                               offs=offs)
        e = max_abs_err([want], [got])
        check(e == 0 and int(got[7, offs.nlog])
              == int(slots[rows == 7].max()) + 1,
              f"log_replay D={len(rows)}: kernel differs from plain "
              f"(max abs err {e})")
        err = max(err, e)
        sizes.append(len(rows))
    # a bad row and a bad slot raise and write nothing, with the pairs held
    # in registers (D = 4) and walked (D = 1024); a good call right after
    # is exact
    for d, at in REPLAY_REJECT:
        rows, slots, entries = (x.to(dev) for x in
                                replay_case(S, d, offs, layout, gen_t))
        img = base.clone()
        pos = torch.tensor([at], device=dev)
        for what, bad_rows, bad_slots in (
                ("row", rows.clone().index_fill_(0, pos, S), slots),
                ("slot", rows, slots.clone().index_fill_(0, pos,
                                                         offs.log_cap))):
            try:
                delta_scatter.log_replay_scatter(img, bad_rows, bad_slots,
                                                 entries, offs=offs)
                raised = False
            except IndexError:
                raised = True
            check(raised and torch.equal(img, base),
                  f"log_replay D={len(rows)} with a bad {what}: raised "
                  f"{raised}, image "
                  f"{'unchanged' if torch.equal(img, base) else 'written'}")
        want = ref.log_replay_scatter_ref(base.clone(), rows, slots, entries,
                                          offs=offs)
        got = delta_scatter.log_replay_scatter(img, rows, slots, entries,
                                               offs=offs)
        check(torch.equal(want, got), f"log_replay D={len(rows)} after a "
              f"rejected call differs from its plain version")
    all_sizes = [d for _, _, _, ds in epochs for d in ds]
    D = statistics.mode(all_sizes)
    print(f"log_replay: equals its plain version exactly (tolerance 0) at "
          f"[{S}, {IW}] for D = {sizes} (several entries per row, an old "
          f"nlog above the new slots); a bad row and a bad slot raise "
          f"IndexError and write nothing at D = 4 and 1024, the call right "
          f"after is exact; "
          f"the main path replayed D = "
          f"{dict(sorted(collections.Counter(all_sizes).items()))} "
          f"(padded entries: launches)")
    cases, work, t = replay_timing(base, D, offs, layout, gen_t, flush)
    _, _, t_1k = replay_timing(base, REPLAY_TIMING_D, offs, layout, gen_t,
                               flush)
    ms, wrapper_ms, plain_ms = t["ms"], t["wrapper_ms"], t["plain_ms"]
    EW = layout.log_entry_words
    # the field words' flat indices, precomputed: index_put_ covers the
    # field writes only, not the per-row nlog reduction
    kw, vw = offs.key_words, offs.val_words
    fields = ([offs.log_keys + w for w in range(kw)] + [offs.log_keylen]
              + [offs.log_vals + w for w in range(vw)]
              + [offs.log_vallen, offs.log_op, offs.log_backptr,
                 offs.log_hint, offs.log_vdelta])
    width = [kw] * kw + [1] + [vw] * vw + [1] * 5
    fo = torch.tensor(fields, device=dev, dtype=torch.long)
    fw = torch.tensor(width, device=dev, dtype=torch.long)
    flat = work.view(-1)
    puts = [((c[0].long()[:, None] * IW + fo[None, :]
              + c[1].long()[:, None] * fw[None, :]).reshape(-1),
             c[2].reshape(-1)) for c in cases]
    yard_ms = device_ms(
        [lambda p=p: flat.index_put_((p[0],), p[1]) for p in puts], 64,
        "index_elementwise_kernel", flush)
    bound_ms = D * (EW * 4 * 2 + 4 + 8) / HBM_BYTES_PER_S * 1e3
    bound_1k = 1024 * (EW * 4 * 2 + 4 + 8) / HBM_BYTES_PER_S * 1e3
    clone_ms = image_clone_ms(base)
    print(f"log_replay: kernel {ms:.4f} ms device time for D = {D} entries "
          f"(L2 flushed), {wrapper_ms:.4f} ms per call through the wrapper "
          f"back to back (plain {plain_ms:.4f} ms), bound {bound_ms:.9f} ms "
          f"({D * (EW * 8 + 12)} B); partial yardstick index_put_ over the "
          f"precomputed field-word indices (no nlog) {yard_ms:.4f} ms device "
          f"time; the follower image clone before each replay ({S * IW * 4} "
          f"B each way) {clone_ms:.4f} ms per clone (CUDA events over 32 back "
          f"to back)")
    print(f"log_replay at D = 1024 (an epoch of about a thousand writes on "
          f"a shard): kernel {t_1k['ms']:.4f} ms device time, "
          f"{t_1k['wrapper_ms']:.4f} ms through the wrapper (plain "
          f"{t_1k['plain_ms']:.4f} ms), bound {bound_1k:.9f} ms; with each "
          f"call's rows and slots read just before it: "
          f"{t['ms_pairs_read']:.4f} ms at D = {D}, "
          f"{t_1k['ms_pairs_read']:.4f} ms at D = 1024")
    return ({"name": "log_replay", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/log_replay.cu",
             "replaces": "src/repro/kernels/delta_scatter.py:127",
             "launches": launches["log_replay"], "max_abs_err": err,
             "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
             "index_put_ms": yard_ms, "D": D,
             "ms_pairs_read": t["ms_pairs_read"], "ms_D1024": t_1k["ms"],
             "ms_pairs_read_D1024": t_1k["ms_pairs_read"],
             "wrapper_ms_D1024": t_1k["wrapper_ms"],
             "plain_ms_D1024": t_1k["plain_ms"],
             "bound_ms_D1024": bound_1k}, launches, scatter)


def replay_timing(base: torch.Tensor, D: int, offs, layout, gen,
                  flush: torch.Tensor):
    """The log-replay kernel at D entries (16 cases of D - 1 records each,
    padded as the feed pads them) replayed into a clone of ``base``: its
    device time (L2 flushed), its device time when each call's rows and
    slots were read just before it (as a wrapper that checks their range
    on the host does), its time through the wrapper back to back and the
    plain version's.  It calls only the replay's wrapper and plain
    version, so it times another tree's kernel too, when that tree's
    ``repro_torch`` is imported first.  Returns (cases, the clone, a dict
    of the four times)."""
    from repro_torch.kernels import delta_scatter, ref
    cases = [tuple(x.to(base.device) for x in replay_case(
        base.shape[0], max(D - 1, 1), offs, layout, gen))
        for _ in range(ROTATE)]
    work = base.clone()
    calls = [lambda c=c: delta_scatter.log_replay_scatter(
        work, *c, offs=offs) for c in cases]
    read_first = [lambda c=c: (torch.aminmax(c[0]), torch.aminmax(c[1]),
                               delta_scatter.log_replay_scatter(
                                   work, *c, offs=offs)) for c in cases]
    return cases, work, {
        "ms": device_ms(calls, 64, "log_replay_kernel", flush),
        "ms_pairs_read": device_ms(read_first, 64, "log_replay_kernel",
                                   flush),
        "wrapper_ms": cuda_ms(calls, 200),
        "plain_ms": cuda_ms([lambda c=c: ref.log_replay_scatter_ref(
            work, *c, offs=offs) for c in cases], 50)}


def mixed_ops(rng, n: int, n_keys: int, gen: int) -> list:
    """``n`` ops in benchmarks/service_smoke.py:mixed_ops's mix: 20% PUT,
    10% UPDATE, 5% DELETE, 50% GET, 15% SCAN of 8 keys, over uniform keys;
    values are 16 bytes."""
    from repro_torch.core import Delete, Get, Put, Scan, Update
    from repro_torch.core.keys import int_key
    ops = []
    for k, p in zip(rng.integers(0, n_keys, n), rng.random(n)):
        k = int(k)
        if p < 0.2:
            ops.append(Put(int_key(k), value(k, gen)))
        elif p < 0.3:
            ops.append(Update(int_key(k), value(k, gen)))
        elif p < 0.35:
            ops.append(Delete(int_key(k)))
        elif p < 0.85:
            ops.append(Get(int_key(k)))
        else:
            ops.append(Scan(int_key(k),
                            int_key(min(k + SCAN_ITEMS - 1, n_keys - 1)),
                            expected_items=SCAN_ITEMS))
    return ops


def service_legacy_path(args, dev, flush):
    """The typed service front end over the legacy per-field layout: a
    2-shard, 2-replica ``ShardedHoneycombStore(layout="legacy")`` (the
    shape of ``benchmarks/service_smoke.py:run``) behind
    ``HoneycombService``, loaded through the service; pipelined epochs,
    then serial ones, every answer, stamp and follower held to the model
    and the primaries; then the multi-field scatter kernel against its
    plain version, at two of the path's own deltas and at S = 16,384 rows
    with D = 1024, and timed beside the 24 ``index_copy_`` calls it
    replaces and the packed layout's row scatter.  Returns the
    multi-scatter ``kernels`` entry and the path's launch counts."""
    from repro_torch.analysis import epochsan
    from repro_torch.core import (FIELD_NAMES, HoneycombConfig,
                                  HoneycombService, LegacyTreeSnapshot,
                                  NodeImageLayout, Put,
                                  ReplicationConfig, ShardedHoneycombStore,
                                  TelemetryConfig, decode_wire_stream,
                                  parse_prometheus, prom_value,
                                  uniform_int_boundaries)
    from repro_torch.core.keys import int_key
    from repro_torch.kernels import build, delta_scatter, ops, ref

    cfg = HoneycombConfig(layout="legacy")
    n = 1 << args.service_keys_log2
    rng = np.random.default_rng(args.seed + 2)
    store = ShardedHoneycombStore(
        cfg, shards=2, boundaries=uniform_int_boundaries(n, 2),
        replication=ReplicationConfig(replicas=2, policy="round_robin"),
        device="cuda")
    groups = store.shards
    svc = HoneycombService(store, batch_size=BATCH, pipeline="pipelined",
                           telemetry=TelemetryConfig(trace_sample_rate=0.05))
    model: dict[bytes, bytes] = {}
    wire_bytes = [0]          # exact encoder bytes of every write submitted

    # ---- load through the service: PUTs in a seeded order, one drain ------
    t0 = time.perf_counter()
    load = [Put(int_key(int(i)), value(int(i), 0)) for i in rng.permutation(n)]
    tickets = svc.submit_many(load)
    svc.drain()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(all(t.result().ok for t in tickets), "a load PUT failed")
    for op in load:
        model[op.key] = op.value
        wire_bytes[0] += len(op.encode_wire())
    del load, tickets
    check(all(isinstance(x, LegacyTreeSnapshot) for g in groups
              for x in [g.primary._snapshot]
              + [f.snapshot for f in g.followers]),
          "the store does not hold legacy snapshots")
    print(f"load through the service: {n} PUTs in {load_s:.3f} s "
          f"({n / load_s:.0f} puts/s); per shard heap capacity "
          f"{[g.tree.heap.capacity for g in groups]} rows, height "
          f"{[g.tree.height for g in groups]}; 4 resident snapshots of "
          f"{sum(getattr(groups[0].primary._snapshot, f).nbytes for f in FIELD_NAMES)}"
          f" B in 24 field tensors each")

    # ---- keep two of the path's deltas: a primary's and a follower's ------
    # (the staging hook of each group sees the delta before its followers
    # apply it; the bases are the snapshots it is applied to)
    kept = []

    def keep_hook(g, s):
        feed = g.primary.on_staged

        def hook(payload):
            want = (len(kept) == 0 and s == 0) or (len(kept) == 1 and s == 1)
            if payload.kind != "delta" or not want:
                return feed(payload)
            f = g.followers[0]
            p_base = g.primary._snapshot
            f_base = f._standby if f._standby is not None else f.snapshot
            feed(payload)
            who = "primary" if s == 0 else "follower"
            kept.append((f"shard {s} {who}", payload.delta,
                         p_base if s == 0 else f_base,
                         payload.snapshot if s == 0 else f._standby))
        g.primary.on_staged = hook
    for s, g in enumerate(groups):
        keep_hook(g, s)

    followers_checked = [0]

    def check_followers(what: str) -> None:
        """Every in-sync follower holds its primary's 24 field tensors,
        page table and read version, bit for bit."""
        for s, g in enumerate(groups):
            p = g.primary._snapshot
            for f in g.followers:
                if f.paused or not f.in_sync or f.epoch != g.primary.epoch:
                    continue
                check(f.snapshot_rv == g.primary._snapshot_rv
                      and all(torch.equal(getattr(f.snapshot, name),
                                          getattr(p, name))
                              for name in FIELD_NAMES + ("pagetable",)),
                      f"{what}: shard {s} follower {f.replica_id} differs "
                      f"from its primary")
                followers_checked[0] += 1

    last_seen: dict[bytes, int] = {}
    counts = collections.Counter()

    def epoch(service, label: str, gen: int) -> float:
        """One epoch: SERVICE_OPS ops through the wire codec and the
        service, one drain; every response against the model, the stamps
        and the followers checked.  Returns the drain's host seconds."""
        ops_ = mixed_ops(rng, SERVICE_OPS, n, gen)
        stream = b"".join(op.encode_wire() for op in ops_)
        decoded = decode_wire_stream(stream)
        check(decoded == ops_, f"{label}: the wire codec changed an op")
        wire_bytes[0] += sum(len(op.encode_wire()) for op in decoded
                             if op.IS_WRITE)
        tickets = service.submit_many(decoded)
        # the read batches the scheduler will dispatch (a GET batch is one
        # device batch; a SCAN batch may add floor back-fill batches)
        buckets = service.scheduler._buckets
        counts["get_batches"] += sum(-(-len(r) // BATCH) for key, r in
                                     buckets.items() if key[2] == "get")
        counts["scan_batches"] += sum(-(-len(r) // BATCH) for key, r in
                                      buckets.items() if key[2] == "scan")
        t = time.perf_counter()
        service.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        for op in decoded:                 # writes land before the reads
            if op.KIND in ("put", "update"):
                model[op.key] = op.value
            elif op.KIND == "delete":
                model.pop(op.key, None)
        keys_sorted = sorted(model)
        for tk in tickets:
            op, r = tk.op, tk.result()
            kind = op.KIND
            counts[kind] += 1
            if op.IS_WRITE:
                check(r.status == "ok", f"{label}: {op} -> {r}")
                continue
            if kind == "get":
                want = model.get(op.key)
                check(r.value == want and r.status == ("ok" if want
                                                       is not None
                                                       else "not_found"),
                      f"{label}: GET {op.key!r} -> {r}")
            else:
                check(r.status == "ok" and r.items == model_scan(
                    keys_sorted, model, op.lo, op.hi),
                      f"{label}: SCAN {op.lo!r}..{op.hi!r}")
            prim = groups[r.shard].primary.serving_version
            check(r.serving_version >= prim
                  and (r.replica > 0 or r.serving_version == prim),
                  f"{label}: {op} served at {r.serving_version} by replica "
                  f"{r.replica}, primary at {prim}")
            counts["follower_reads" if r.replica else "primary_reads"] += 1
            check(r.serving_version >= last_seen.get(op.route_key, 0),
                  f"{label}: {op.route_key!r} went back in version")
            last_seen[op.route_key] = r.serving_version
        check_followers(label)
        return dt

    # ---- the main path, every launch count set to 0 just before it -------
    # (EpochSan on, strict, over the pipelined and serial epochs; off in
    # the timings below)
    with epochsan.enabled() as san:
        build.reset_launches()
        ops.reset_read_dispatches()
        sync0 = [[dataclasses.replace(s) for s in g.per_replica_sync_stats]
                 for g in groups]
        gen = 1
        pipelined_s = []
        stall0 = svc.stats.sync_stall_s
        for e in range(SERVICE_EPOCHS):
            pipelined_s.append(epoch(svc, f"pipelined epoch {e}", gen))
            gen += 1
        stall_pipelined = (svc.stats.sync_stall_s - stall0) / SERVICE_EPOCHS
        serial = HoneycombService(store, batch_size=BATCH, pipeline="serial")
        serial_s = []
        for e in range(SERIAL_EPOCHS):
            serial_s.append(epoch(serial, f"serial epoch {e}", gen))
            gen += 1
        stall_serial = serial.stats.sync_stall_s / SERIAL_EPOCHS
        launches = dict(build.LAUNCHES)
        dispatches = ops.read_dispatch_stats()
    epochsan_report("service_legacy", san, ("read_checks", "stagings",
                                            "flips", "dispatch_checks"))

    # ---- counts ----------------------------------------------------------
    applies = sum(s1.delta_syncs - s0.delta_syncs
                  for g, ss0 in zip(groups, sync0)
                  for s0, s1 in zip(ss0, g.per_replica_sync_stats))
    primary_deltas = sum(g.primary.sync_stats.delta_syncs - ss0[0].delta_syncs
                         for g, ss0 in zip(groups, sync0))
    check(applies > primary_deltas > 0,
          f"delta syncs: {primary_deltas} primary, {applies} in all")
    check(launches["multi_scatter"] == applies,
          f"multi_scatter launches {launches} vs {applies} delta syncs "
          f"(primaries and followers)")
    check(launches["fused_get"] == launches["fused_scan"]
          == launches["row_scatter"] == launches["log_replay"] == 0,
          f"the legacy path launched another kernel: {launches}")
    check(set(dispatches) == {"get_reference", "scan_reference"}
          and dispatches["get_reference"]["batches"] == counts["get_batches"]
          and dispatches["scan_reference"]["batches"]
          >= counts["scan_batches"],
          f"read dispatches {dispatches} vs {counts['get_batches']} GET and "
          f"{counts['scan_batches']} SCAN scheduler batches")
    check(store.sync_stats.log_wire_bytes == wire_bytes[0],
          f"wire bytes {wire_bytes[0]} vs the store's log_wire_bytes "
          f"{store.sync_stats.log_wire_bytes}")
    fs = store.feed_stats
    check(fs.log_feed_epochs == 0 and fs.delta_feed_epochs > 0,
          f"legacy feed {fs}")
    text = svc.prometheus()
    parsed = parse_prometheus(text)
    n_get = prom_value(parsed, "hc_read_get_latency_seconds_count")
    n_scan = prom_value(parsed, "hc_read_scan_latency_seconds_count")
    check(n_get > 0 and n_scan > 0,
          f"latency histograms: {n_get} GETs, {n_scan} SCANs")
    traces = svc.traces()
    chain = ("submit", "export_stage", "flip", "resolve")
    write_tr = [t for t in traces if "admit" in t.span_names()
                and all(c in t.span_names() for c in chain)]
    read_tr = [t for t in traces if "dispatch" in t.span_names()
               and all(c in t.span_names() for c in chain)]

    def in_order(t, names):
        got = [s for s in t.span_names() if s in names]
        return got == list(names)
    check(any(in_order(t, ("submit", "admit", "export_stage", "flip",
                           "resolve")) for t in write_tr)
          and any(in_order(t, ("submit", "export_stage", "flip", "dispatch",
                               "resolve")) for t in read_tr),
          f"no sampled trace carries the lifecycle chain "
          f"({len(traces)} traces)")
    tm = svc.telemetry
    q = {(op, p): tm.quantile(f"read_{op}_latency_seconds", p)
         for op in ("get", "scan") for p in (50, 99)}
    print(f"checked {counts['get']} GETs, {counts['scan']} SCANs and "
          f"{counts['put'] + counts['update'] + counts['delete']} writes "
          f"against the model ({counts['follower_reads']} reads served by "
          f"followers); {followers_checked[0]} follower checks bit-identical "
          f"to their primary (24 fields + page table)")
    print(f"  launches {launches}; read dispatches {dispatches}")
    print(f"  delta syncs: {primary_deltas} on primaries, "
          f"{applies - primary_deltas} follower delta applies; "
          f"{store.sync_stats}")
    print(f"  feed {fs}")
    print(f"  wire bytes of every write submitted {wire_bytes[0]} == the "
          f"store's log_wire_bytes; Prometheus text of {len(text)} B "
          f"parses; {len(traces)} sampled traces")
    med = statistics.median(pipelined_s)
    print(f"  pipelined drain epoch of {SERVICE_OPS} ops (host clock): "
          f"median {med * 1e3:.3f} ms, max {max(pipelined_s) * 1e3:.3f} ms, "
          f"{SERVICE_OPS / med:.0f} ops/s; serial epochs "
          f"{[round(x * 1e3, 3) for x in serial_s]} ms")
    print(f"  sync_stall_s per epoch: pipelined {stall_pipelined * 1e3:.4f} "
          f"ms, serial {stall_serial * 1e3:.4f} ms")
    print(f"  registry latency per request (batch device time spread over "
          f"its requests): GET p50 {q['get', 50] * 1e3:.4f} ms, p99 "
          f"{q['get', 99] * 1e3:.4f} ms; SCAN p50 {q['scan', 50] * 1e3:.4f} "
          f"ms, p99 {q['scan', 99] * 1e3:.4f} ms")

    # ---- the device's busy share over one drain epoch --------------------
    # (after the counts were read; its launches are not the main path's)
    box = []
    events, window_us = device_events(
        lambda: box.append(epoch(svc, "traced epoch", gen)))
    gen += 1
    busy_us = sum(t for _, t in events)
    print(f"device busy {busy_us / window_us:.4f} of one pipelined drain "
          f"epoch ({busy_us:.1f} of {window_us:.1f} us, torch.profiler)")
    print_activities(events, "service epoch")

    # ---- each primary's snapshot equals a fresh full publish of its heap -
    for s, g in enumerate(groups):
        snap = g.primary._snapshot
        for name in FIELD_NAMES:
            want = g.primary._dev(g.primary._field_rows(name))
            check(torch.equal(getattr(snap, name), want),
                  f"shard {s}: field {name} differs from the heap")
        check(torch.equal(snap.pagetable,
                          g.primary._dev(g.tree.pt.device_image)),
              f"shard {s}: page table differs from the host's")
    print("each primary's 24 field tensors and page table equal a fresh "
          "full publish of its host heap")

    # ---- the kernel against its plain version at the path's deltas -------
    check(len(kept) == 2, f"kept {len(kept)} deltas")
    err = 0
    for label, delta, base, published in kept:
        S, D = base.ntype.shape[0], delta.rows.shape[0]
        outs = []
        for fn in (ref.snapshot_multi_scatter_ref,
                   delta_scatter.snapshot_multi_scatter):
            fields = [getattr(base, f).clone().view(S, -1)
                      for f in FIELD_NAMES]
            outs.append(fn(fields, delta.rows,
                           [getattr(delta, f).reshape(D, -1)
                            for f in FIELD_NAMES]))
        pub = [getattr(published, f).view(S, -1) for f in FIELD_NAMES]
        e = max_abs_err(outs[0] + outs[0], outs[1] + tuple(pub))
        check(e == 0, f"multi_scatter at the {label} delta (D={D}): kernel, "
              f"plain version and the published snapshot differ ({e})")
        err = max(err, e)
    print(f"multi_scatter at the path's deltas ({', '.join(k[0] for k in kept)};"
          f" D = {[k[1].rows.numel() for k in kept]}): kernel equals its plain "
          f"version and the published snapshot exactly (tolerance 0)")
    del kept[:]

    # ---- ... and at S = 16,384 rows, D = 1024 padded with repeats ---------
    layout = NodeImageLayout.for_config(cfg)
    widths = [sl.words for sl in layout.slots.values()]
    IW = layout.image_words
    S, D = 16384, 1024
    d = D - 117                          # distinct rows; the rest repeat
    gen_t = torch.Generator(device="cpu").manual_seed(args.seed)
    dsts = [torch.randint(-2 ** 31, 2 ** 31 - 1, (S, w), generator=gen_t,
                          dtype=torch.int32).to(dev) for w in widths]
    cases = []
    for _ in range(8):
        rows = torch.randperm(S, generator=gen_t)[:d].to(torch.int32)
        rows = torch.cat([rows, rows[-1:].expand(D - d)]).to(dev)
        upd = []
        for w in widths:
            u = torch.randint(-2 ** 31, 2 ** 31 - 1, (d, w), generator=gen_t,
                              dtype=torch.int32)
            upd.append(torch.cat([u, u[-1:].expand(D - d, w)]).to(dev))
        cases.append((rows, upd, rows.long()))
    for rows, upd, rows_long in cases[:2]:
        want = ref.snapshot_multi_scatter_ref([t.clone() for t in dsts],
                                              rows, upd)
        got = delta_scatter.snapshot_multi_scatter(
            [t.clone() for t in dsts], rows, upd)
        lib = [t.clone().index_copy_(0, rows_long, u)
               for t, u in zip(dsts, upd)]
        e = max_abs_err(list(want) + list(want), list(got) + lib)
        check(e == 0, f"multi_scatter at S={S}, D={D}: kernel differs from "
              f"plain (max abs err {e})")
        err = max(err, e)
    calls = [lambda c=c: delta_scatter.snapshot_multi_scatter(dsts, c[0],
                                                              c[1])
             for c in cases]
    ms = device_ms(calls, 64, "multi_scatter_kernel", flush)
    # the design's fixed cost: the same launch copying one row
    floor_ms = device_ms(
        [lambda c=c: delta_scatter.snapshot_multi_scatter(
            dsts, c[0][:1].expand(D).contiguous(),
            [u[:1].expand(D, u.shape[1]).contiguous() for u in c[1]])
         for c in cases], 64, "multi_scatter_kernel", flush)
    wrapper_ms = cuda_ms(calls, 200)
    plain_ms = cuda_ms([lambda c=c: ref.snapshot_multi_scatter_ref(
        dsts, c[0], c[1]) for c in cases], 50)

    def index_copies(c):
        for t, u in zip(dsts, c[1]):
            t.index_copy_(0, c[2], u)
    library_ms = device_ms([lambda c=c: index_copies(c) for c in cases], 32,
                           "index_copy", flush, per_call=len(dsts))
    image = torch.randint(-2 ** 31, 2 ** 31 - 1, (S, IW), generator=gen_t,
                          dtype=torch.int32).to(dev)
    packed_cases = [(c[0], torch.cat([u for u in c[1]], dim=1).contiguous())
                    for c in cases[:4]]
    row_ms = device_ms([lambda c=c: delta_scatter.snapshot_image_scatter(
        image, c[0], c[1]) for c in packed_cases], 64, "row_scatter_kernel",
        flush)
    bound_ms = scatter_bound_ms(d, IW, D)
    print(f"multi_scatter: equals its plain version and 24 index_copy_ calls "
          f"exactly (tolerance 0) at S = {S} rows, D = {D} ({d} distinct), "
          f"24 fields of 1 to {max(widths)} words ({IW} in all); kernel "
          f"{ms:.4f} ms device time in one launch (L2 flushed), "
          f"{wrapper_ms:.4f} ms per call through the wrapper back to back "
          f"(plain {plain_ms:.4f} ms), 24 index_copy_ launches "
          f"{library_ms:.4f} ms device time in all, bound {bound_ms:.6f} ms "
          f"({2 * d * IW * 4 + D * 4} B); the packed layout's row scatter of "
          f"the same rows as one [{S}, {IW}] image {row_ms:.4f} ms")
    print(f"  multi_scatter: the same launch copying one row (every row a "
          f"repeat of the first) {floor_ms:.4f} ms")
    return ({"name": "multi_scatter", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/multi_scatter.cu",
             "replaces": "src/repro/kernels/delta_scatter.py:178",
             "launches": launches["multi_scatter"], "max_abs_err": err,
             "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes",
             "library_ms": library_ms, "row_scatter_packed_ms": row_ms,
             "D": D, "S": S, "floor_ms": floor_ms}, launches)


def serving_path(args, dev, flush):
    """The serving engine at qwen2.5-3b's full widths and depth (random
    bf16 weights from ``--seed``): ``ServingEngine`` with 8 slots, pages of
    256 tokens and 32 pages a sequence (max_seq 8192), whose page table is
    a ``HoneycombStore`` on the card, serves 16 requests of 1,024-4,000
    prompt tokens and 32 new tokens each.  Every decode step looks its
    block tables up with one fused GET batch (page allocations make the
    next lookup sync a delta through the row scatter), and every attention
    layer of the step runs the paged-attention kernel.  Then: every
    request's length, the pages in use and the page table's puts/deletes
    against a dict model, the launch counts, the served tokens against a
    plain full forward, teacher-forced logits through the kernel and
    through the plain attention against the full forward, and the kernel
    against its plain version at the engine's own shapes and live lengths,
    with its timings.  Returns the ``paged_attention`` entry of the
    ``kernels`` line and the path's launch counts."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, paged_attention, ref
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine, page_key

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False (f32 products in full f32)")
    t_path = time.perf_counter()
    cfg = get_config("qwen2.5-3b")
    P, slots, max_seq, new = SERVING_PAGE, SERVING_SLOTS, SERVING_MAX_SEQ, \
        SERVING_NEW_TOKENS
    n_params = cfg.param_count()
    check(n_params == QWEN_PARAMS, f"qwen2.5-3b has {n_params} parameters "
          f"by the port's schema, the reference counts {QWEN_PARAMS}")
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_size=slots, max_seq=max_seq, page_size=P,
                        seed=args.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = sum(t.numel() for t in sc.flatten(eng.model.params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in sc.flatten(eng.model.params))
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in sc.flatten(eng.pools))
    check(held == n_params, f"the engine holds {held} parameters, the "
          f"schema counts {n_params}")
    print(f"qwen2.5-3b: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, head "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} "
          f"parameters (the reference's param_count() is {QWEN_PARAMS}), "
          f"{param_bytes} B of bf16 weights drawn on the card in "
          f"{init_s:.3f} s; KV pools {eng.kv.n_pages} pages of {P} tokens, "
          f"{pool_bytes} B")

    rng = np.random.default_rng(args.seed)
    lens = [int(n) for n in rng.integers(1024, 4001, SERVING_REQUESTS)]
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]

    # ---- the main path, every launch count set to 0 just before it -------
    torch.cuda.empty_cache()
    build.reset_launches()
    trace, live = None, None
    t0 = time.perf_counter()
    while True:
        steps = eng.stats["decode_steps"]
        if steps == SERVING_TRACE_AT:   # 3 decode-only steps, 8 slots busy
            trace = device_events(lambda: eng.run_until_done(max_ticks=3))
            # the 8 sequences' live lengths after them, and their pages
            # (host-tree GETs, no launch), for the kernel's own check
            live = []
            for rid in rids[:slots]:
                n = lens[rid] + SERVING_TRACE_AT + 3
                live.append((n, [int.from_bytes(
                    eng.kv.table.get(page_key(rid, b)), "big")
                    for b in range(-(-n // P))]))
        else:
            eng.run_until_done(max_ticks=1)
        if eng.stats["decode_steps"] == steps:
            break                           # every request is done
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    outs = eng.run_until_done()

    # ---- lengths, pages, the page table against a dict model, launches ---
    check(all(len(outs[r]) == new for r in rids),
          f"a request did not return {new} tokens")
    check(eng.kv.pages_in_use == 1, f"{eng.kv.pages_in_use} pages in use "
          f"after the run, not the scratch page alone")
    puts, deletes, left = page_table_model(rids, lens, P, new)
    st = eng.kv.table.stats
    check(not left and st.puts == puts and st.deletes == deletes,
          f"page table puts/deletes {st.puts}/{st.deletes}, the dict model "
          f"{puts}/{deletes} ({left} pages left)")
    steps = eng.stats["decode_steps"]
    check(launches["paged_attention"] == cfg.n_layers * steps,
          f"{launches['paged_attention']} paged_attention launches for "
          f"{steps} decode steps of {cfg.n_layers} layers")
    check(launches["fused_get"] == steps and launches["row_scatter"] > 0,
          f"block-table lookups: {launches['fused_get']} fused GETs for "
          f"{steps} decode steps, {launches['row_scatter']} row scatters")
    check(all(v == 0 for k, v in launches.items() if k not in
              ("paged_attention", "fused_get", "row_scatter")),
          f"the serving path launched another kernel: {launches}")
    prefill_ms = [eng.prefill_s[r] * 1e3 for r in rids]
    decode_ms = [t * 1e3 for i, t in enumerate(eng.decode_s)
                 if not SERVING_TRACE_AT <= i < SERVING_TRACE_AT + 3]
    events, window_us = trace
    busy_us = sum(t for _, t in events)
    print(f"served {len(rids)} requests ({SERVING_REQUESTS // slots} waves "
          f"of {slots} slots), prompts {min(lens)}-{max(lens)} tokens "
          f"(padded to {P}), {new} new tokens each: {eng.stats['tokens']} "
          f"tokens, {steps} decode steps in {run_s:.3f} s, "
          f"{eng.stats['tokens'] / run_s:.1f} tokens/s (host clock)")
    print(f"  prefill per request (host clock, ms, prompt tokens): "
          + ", ".join(f"{m:.1f} ({n})" for m, n in zip(prefill_ms, lens)))
    print(f"  decode step (host clock, block-table GET batch of "
          f"{slots * eng.pps} keys, {cfg.n_layers} layers, {slots} slots): "
          f"median {statistics.median(decode_ms):.3f} ms, max "
          f"{max(decode_ms):.3f} ms over {len(decode_ms)} untraced steps")
    print(f"  device busy {busy_us / window_us:.4f} of 3 traced decode steps "
          f"({busy_us:.1f} of {window_us:.1f} us)")
    print_activities(events, "decode steps")
    print(f"  page table: puts {st.puts} == deletes {st.deletes} == the dict "
          f"model's; pages in use after the run 1 (scratch); launches "
          f"{launches}")

    print(f"  ({time.perf_counter() - t_path:.3f} s into the path)")

    # ---- the served tokens against a plain full forward -------------------
    gaps = []
    for rid in (int(np.argmin(lens)), int(np.argmax(lens))):
        S, out = lens[rid], outs[rid]
        seq = np.concatenate([prompts[rid], np.asarray(out[:-1], np.int32)])
        logits = eng.model(torch.from_numpy(seq[None]).to(dev))[0, S - 1:]
        rows = torch.arange(new, device=dev)
        gap = logits.max(dim=-1).values \
            - logits[rows, torch.tensor(out, device=dev)]
        gaps.append(float(gap.max()))
        agree = int((logits.argmax(dim=-1).cpu()
                     == torch.tensor(out)).sum())
        print(f"  request {rid} ({S} prompt tokens): the full forward's "
              f"argmax equals {agree} of {new} served tokens; largest gap "
              f"between a served token's logit and its row's max "
              f"{gaps[-1]:.4f} (tolerance {TOKEN_GAP_TOL})")
        del logits
    check(max(gaps) <= TOKEN_GAP_TOL, f"a served token's logit lies "
          f"{max(gaps):.4f} below its row's max in the full forward")

    print(f"  ({time.perf_counter() - t_path:.3f} s into the path)")

    # ---- teacher-forced: prefill + 8 decode steps vs the full forward -----
    rid = int(np.argmax(lens))
    S, out = lens[rid], outs[rid]
    feed = np.asarray(out[:TEACHER_STEPS], np.int32)
    full = eng.model(torch.from_numpy(np.concatenate(
        [prompts[rid], feed])[None]).to(dev))[0, S - 1:]
    padded = np.pad(prompts[rid], (0, -S % P))
    with torch.inference_mode():
        first, cache = eng.model.prefill(torch.from_numpy(padded[None])
                                         .to(dev), P, S - 1)
        spare = {n: {k: torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
                     for k, t in c.items()} for n, c in cache.layers.items()}
    pps = len(padded) // P + 1
    decoded, step_ms = {}, {}
    for name, attn in (("kernel", None), ("plain", ref.paged_attention_ref)):
        c = tf.DecodeCache(sc.map_tree(torch.clone, spare),
                           torch.arange(pps, dtype=torch.int32,
                                        device=dev)[None],
                           torch.tensor([S], dtype=torch.int32, device=dev))
        rows, ts = [], []
        for i in range(TEACHER_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, c = eng.model.decode_step(
                c, torch.tensor([[int(feed[i])]], device=dev), P, attn)
            rows.append(lg[0])
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3)
        decoded[name] = torch.stack(rows)
        step_ms[name] = statistics.median(ts)
    prefill_err = float((first[0] - full[0]).abs().max())
    teacher = {n: float((d - full[1:]).abs().max())
               for n, d in decoded.items()}
    between = float((decoded["kernel"] - decoded["plain"]).abs().max())
    print(f"  teacher-forced, request {rid} ({S} prompt tokens): prefill + "
          f"{TEACHER_STEPS} decode steps vs the full forward's logits "
          f"(|logit| up to {float(full.abs().max()):.2f}): max abs diff "
          f"through the kernel {teacher['kernel']:.4f}, through the plain "
          f"attention {teacher['plain']:.4f} (tolerance {TEACHER_TOL}: bf16 "
          f"weights and activations round at other steps in the two "
          f"orders); kernel vs plain attention {between:.4f} (tolerance "
          f"{KERNEL_VS_PLAIN_TOL}); prefill's last-token logits "
          f"{prefill_err:.4f}; decode step of one sequence, median host "
          f"clock: kernel {step_ms['kernel']:.3f} ms, plain attention "
          f"{step_ms['plain']:.3f} ms")
    check(max(teacher.values()) <= TEACHER_TOL and prefill_err <= TEACHER_TOL,
          f"teacher-forced logits differ from the full forward by "
          f"{teacher} (prefill {prefill_err:.4f})")
    check(between <= KERNEL_VS_PLAIN_TOL, f"decode logits through the kernel "
          f"and through the plain attention differ by {between:.4f}")
    del full, first, cache, spare, decoded

    print(f"  ({time.perf_counter() - t_path:.3f} s into the path)")

    # ---- the kernel vs its plain version at the engine's shapes ----------
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp = eng.pools["l0"]["k_pages"][0]          # layer 0's live pool
    vp = eng.pools["l0"]["v_pages"][0]
    bt = torch.zeros(slots, eng.pps, dtype=torch.int32)
    for i, (_, pages) in enumerate(live):     # past seq_lens: page 0
        bt[i, :len(pages)] = torch.tensor(pages)
    bt = bt.to(dev)
    sl = torch.tensor([n for n, _ in live], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q = torch.randn(slots, H, D, generator=gen, device=dev) \
        .to(torch.bfloat16)
    scale = D ** -0.5
    err = 0.0
    for dtype, tol in ((torch.bfloat16, dict(rtol=2 ** -7, atol=1e-6)),
                       (torch.float32, dict(rtol=1e-5, atol=1e-5))):
        args_ = (q.to(dtype), kp.to(dtype), vp.to(dtype), bt, sl)
        got = paged_attention.paged_attention(*args_, scale=scale)
        want = ref.paged_attention_ref(*args_, scale=scale)
        e = float((got.float() - want.float()).abs().max())
        try:
            torch.testing.assert_close(got, want, **tol)
        except AssertionError as exc:
            raise SmokeFailure(f"paged_attention ({dtype}) vs plain: {exc}")
        err = max(err, e)
        print(f"paged_attention vs its plain version, {dtype} pools: max abs "
              f"err {e:.3g} (tolerance rtol {tol['rtol']:.3g}, atol "
              f"{tol['atol']:.3g})")
    plan = paged_attention.span_plan(slots, H, KVH, eng.pps, P, D, kp.dtype)
    print(f"paged_attention span plan at the engine's shapes: "
          f"{plan._asdict()} (grid {slots} x {KVH} x {plan.n_spans} split "
          f"blocks of {paged_attention.THREADS} threads, then {slots * H} "
          f"combining blocks)")
    call = [lambda: paged_attention.paged_attention(q, kp, vp, bt, sl,
                                                    scale=scale)]
    # a call launches the split kernel and the combining kernel; both
    # names hold "paged_attention_kernel"
    ms = device_ms(call, 64, "paged_attention_kernel", flush, per_call=2)
    split_ms = device_ms(call, 64, "paged_attention_kernel_split", flush)
    wrapper_ms = cuda_ms(call, 200)
    plain_ms = cuda_ms([lambda: ref.paged_attention_ref(q, kp, vp, bt, sl,
                                                        scale=scale)], 16)
    # the latency of one live block's chain and the combine: one sequence
    # of one span's positions
    one = torch.tensor([plan.span], dtype=torch.int32, device=dev)
    one_ms = device_ms([lambda: paged_attention.paged_attention(
        q[:1].contiguous(), kp, vp, bt[:1].contiguous(), one, scale=scale)],
        64, "paged_attention_kernel", flush, per_call=2)
    # partial yardstick: SDPA over the K/V already gathered to dense
    # [B, KVH, PPS * P, D] (no page gather), the window as a mask
    kd = kp[bt.long()].reshape(slots, -1, KVH, D).transpose(1, 2) \
        .contiguous()
    vd = vp[bt.long()].reshape(slots, -1, KVH, D).transpose(1, 2) \
        .contiguous()
    mask = (torch.arange(kd.shape[2], device=dev)[None, :]
            < sl[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None], kd, vd,
                                              attn_mask=mask, scale=scale,
                                              enable_gqa=True)
    sdpa_err = float((sdpa()[:, :, 0].float() - ref.paged_attention_ref(
        q, kp, vp, bt, sl, scale=scale).float()).abs().max())
    library_ms = device_all_ms([sdpa], 64, flush)
    live_pos = int(sl.sum())
    io = live_pos * KVH * D * 2 * kp.element_size() \
        + 2 * q.numel() * q.element_size() \
        + 4 * (sum(len(pages) for _, pages in live) + 2 * slots)
    ops_ = 4 * H * D * live_pos
    bytes_ms = io / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"paged_attention at B = {slots}, H = {H}, KVH = {KVH}, D = {D}, "
          f"P = {P}, PPS = {eng.pps}, bf16, live lengths "
          f"{[n for n, _ in live]}: kernel {ms:.4f} ms device time, split "
          f"{split_ms:.4f} + combine {ms - split_ms:.4f} (L2 flushed; "
          f"before the redesign {BEFORE_MS['paged_attention']:.4f} ms; one "
          f"sequence of {plan.span} positions {one_ms:.4f} ms), "
          f"{wrapper_ms:.4f} ms per call through the wrapper back "
          f"to back (plain {plain_ms:.4f} ms), bound {bound_ms:.6f} ms "
          f"({io} B over {HBM_BYTES_PER_S:.3g} B/s; {ops_} flops over "
          f"{BF16_FLOPS:.3g}/s take {ops_ms:.6f} ms); partial yardstick "
          f"scaled_dot_product_attention over the gathered K/V "
          f"{library_ms:.4f} ms device time (max abs diff to plain "
          f"{sdpa_err:.3g})")
    entry = {"name": "paged_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:85",
             "launches": launches["paged_attention"], "max_abs_err": err,
             "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms,
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "library_ms": library_ms, "B": slots,
             "live_positions": live_pos, "split_ms": split_ms,
             "one_span_ms": one_ms,
             "decode_step_ms": statistics.median(decode_ms),
             "tokens_per_s": eng.stats["tokens"] / run_s}
    del eng, kd, vd, kp, vp
    torch.cuda.empty_cache()
    entry["shapes"] = [paged_shape_check(args, dev, flush, *shape)
                       for shape in PAGED_SHAPES]
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [x["max_abs_err"] for x in entry["shapes"]])
    return entry, launches


def paged_shape_check(args, dev, flush, name, H, KVH, D, softcap, window):
    """The paged-attention kernel against its plain version on seeded
    synthetic pools at another carried config's attention shape (8
    sequences of 1,024-8,192 positions in pages of 256, a sliding window
    of ``window`` positions, ``softcap``), in bf16 and in f32 with the
    serving check's tolerances; then its device time beside its bound."""
    from repro_torch.kernels import paged_attention, ref
    B, P, PPS = SERVING_SLOTS, SERVING_PAGE, SERVING_MAX_SEQ // SERVING_PAGE
    rng = np.random.default_rng(args.seed + D + H)
    lens = rng.integers(1024, PPS * P + 1, B)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    start = torch.tensor(np.maximum(lens - window, 0), dtype=torch.int32,
                         device=dev)
    bt = torch.tensor(1 + rng.permutation(B * PPS).reshape(B, PPS),
                      dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + D)
    kp, vp = (torch.randn(B * PPS + 1, P, KVH, D, generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(scale=D ** -0.5, softcap=softcap)
    err = 0.0
    for dtype, tol in ((torch.bfloat16, dict(rtol=2 ** -7, atol=1e-6)),
                       (torch.float32, dict(rtol=1e-5, atol=1e-5))):
        a = (q.to(dtype), kp.to(dtype), vp.to(dtype), bt, sl, start)
        got = paged_attention.paged_attention(*a, **kw)
        want = ref.paged_attention_ref(*a, **kw)
        try:
            torch.testing.assert_close(got, want, **tol)
        except AssertionError as exc:
            raise SmokeFailure(f"paged_attention at {name}'s shape ({dtype}) "
                               f"vs plain: {exc}")
        err = max(err, float((got.float() - want.float()).abs().max()))
        del a, got, want
    plan = paged_attention.span_plan(B, H, KVH, PPS, P, D, kp.dtype)
    ms = device_ms([lambda: paged_attention.paged_attention(
        q, kp, vp, bt, sl, start, **kw)], 64, "paged_attention_kernel",
        flush, per_call=2)
    hi = np.minimum(lens, PPS * P)
    lo = np.maximum(lens - window, 0)
    vis = int((hi - lo).sum())
    pages = int((-(-hi // P) - lo // P).sum())
    io = vis * KVH * D * 2 * kp.element_size() \
        + 2 * q.numel() * q.element_size() + 4 * (pages + 2 * B)
    ops_ = 4 * H * D * vis
    bound_ms = max(io / HBM_BYTES_PER_S, ops_ / BF16_FLOPS) * 1e3
    print(f"paged_attention at {name}'s shape (B = {B}, H = {H}, KVH = "
          f"{KVH}, D = {D}, softcap {softcap}, window {window}, lengths "
          f"{lens.tolist()}): equals its plain version in bf16 and f32 "
          f"(max abs err {err:.3g}); plan {plan._asdict()}; kernel "
          f"{ms:.4f} ms device time (L2 flushed), bound {bound_ms:.6f} ms "
          f"({io} B)")
    del kp, vp
    torch.cuda.empty_cache()
    return {"name": name, "ms": ms, "bound_ms": bound_ms,
            "max_abs_err": err}


def moe_ssm_serving_path(args, dev, flush):
    """Path 6: ``ServingEngine`` with olmoe-1b-7b and mamba2-1.3b at full
    widths and depth and jamba-v0.1-52b at full widths cut to one
    superblock, one engine after another (each freed before the next),
    random bf16 weights from ``--seed``, 8 slots, pages of 256 tokens, 16
    pages a sequence; 8 requests of 1,024-2,048 prompt tokens and 16 new
    tokens each (``serve_moe_ssm``).  Returns the launch counts summed
    over the three engines' runs and the paged-attention kernel's checks
    at the olmoe (G = 1) and jamba (G = 4) engines' shapes."""
    launches, shapes = collections.Counter(), []
    for arch, layers, n_params, n_active in MOE_SSM_MODELS:
        t0 = time.perf_counter()
        counts, shape = serve_moe_ssm(args, dev, flush, arch, layers,
                                      n_params, n_active)
        launches.update(counts)
        shapes += shape
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {arch}: {time.perf_counter() - t0:.3f} s with its checks "
              f"and timings")
    return launches, shapes


def page_table_model(rids, lens, P: int, new: int) -> tuple:
    """(puts, deletes, pages left) of a dict model of the engine's page
    table: each request's padded prompt at prefill, a page for each decode
    step's token where its page is new, every page freed on completion."""
    table, puts, deletes = {}, 0, 0
    for rid, S in zip(rids, lens):
        for b in range(-(-S // P)):             # prefill: the padded prompt
            table[(rid, b)] = True
            puts += 1
        for pos in range(S, S + new - 1):       # each decode step's token
            if (rid, pos // P) not in table:
                table[(rid, pos // P)] = True
                puts += 1
        for b in range(-(-(S + new) // P)):     # free on completion
            deletes += table.pop((rid, b), False)
    return puts, deletes, len(table)


def full_logits(model, toks: np.ndarray, dev) -> torch.Tensor:
    """A plain full forward's logits [S, V] of ``toks``, right-padded to a
    multiple of 64: an SSD chunk must divide the length, and the pad
    changes no earlier logit (every layer is causal)."""
    padded = np.pad(toks, (0, -len(toks) % 64))
    return model(torch.from_numpy(padded[None]).to(dev))[0, :len(toks)]


def served_gap(model, prompts: dict, outs: dict, dev) -> tuple:
    """Every served token against a plain full forward over its prompt and
    the tokens served before it: (largest gap between a served token's
    logit and its row's maximum, served tokens that are the forward's
    argmax, served tokens)."""
    gap, agree, n = 0.0, 0, 0
    for rid, prompt in prompts.items():
        out = torch.tensor(outs[rid])
        seq = np.concatenate([prompt, out[:-1].numpy().astype(np.int32)])
        logits = full_logits(model, seq, dev)[len(prompt) - 1:]
        chosen = logits[torch.arange(len(out), device=dev), out.to(dev)]
        gap = max(gap, float((logits.max(dim=-1).values - chosen).max()))
        agree += int((logits.argmax(dim=-1).cpu() == out).sum())
        n += len(out)
        del logits
    return gap, agree, n


@contextlib.contextmanager
def moe_routes(forced=None):
    """Record the top-k expert indices of every MoE router call, in call
    order, by wrapping ``moe.router_probs``.  With ``forced`` (index
    tensors [B, n, k], one a call in the same order), each call routes
    its first n positions to those experts instead, weighted by its own
    probabilities renormalised over them."""
    from repro_torch.models import moe
    plain, calls, queue = moe.router_probs, [], list(forced or ())

    def routed(p, x, cfg):
        w, i = plain(p, x, cfg)
        if queue:
            f = queue.pop(0)
            i = i.clone()
            i[:, :f.shape[1]] = f
            probs = torch.softmax(torch.matmul(x.to(torch.float32),
                                               p["router"]), dim=-1)
            w = probs.gather(-1, i)
            w = w / w.sum(dim=-1, keepdim=True)
        calls.append(i)
        return w, i

    moe.router_probs = routed
    try:
        yield calls
    finally:
        moe.router_probs = plain


def teacher_forced(model, prompt: np.ndarray, S: int, P: int,
                   dev) -> torch.Tensor:
    """Logits [k + 1, V] of prefill of ``prompt[:S]`` (padded to pages,
    its state taken at the last real token) and of k teacher-forced
    decode steps on ``prompt[S:]``, k = len(prompt) - S."""
    from repro_torch.models import transformer as tf
    padded = np.pad(prompt[:S], (0, -S % P))
    with torch.inference_mode():
        first, cache = model.prefill(torch.from_numpy(padded[None]).to(dev),
                                     P, S - 1)
        layers = {n: {k: torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
                      if k in tf.KV_LEAVES else t for k, t in c.items()}
                  for n, c in cache.layers.items()}
    c = tf.DecodeCache(layers, torch.arange(len(padded) // P + 1,
                                            dtype=torch.int32,
                                            device=dev)[None],
                       torch.tensor([S], dtype=torch.int32, device=dev))
    rows = [first[0]]
    for tok in prompt[S:]:
        lg, c = model.decode_step(c, torch.tensor([[int(tok)]], device=dev),
                                  P)
        rows.append(lg[0])
    return torch.stack(rows)


def handoff_drift(model, prompt: np.ndarray, P: int, dev) -> dict:
    """Prefill of ``prompt[:-k]`` and k teacher-forced decode steps
    (``teacher_forced``) against a full forward's logits at those k + 1
    positions, k = TEACHER_STEPS.  A model with MoE layers runs the
    handoff twice: with its own routes, and with every route forced to the
    full forward's, so that only rounding separates the two.  Returns
    {"drift": max abs difference, "forced": the same with the routes
    forced (None without MoE), "flips": (MoE layer, position) pairs whose
    own experts differ from the full forward's, "routes": the pairs
    compared, "top": max |logit|}."""
    S = len(prompt) - TEACHER_STEPS
    with moe_routes() as full_routes:
        full = full_logits(model, prompt, dev)[S - 1:]
    with moe_routes() as own:
        drift = float((teacher_forced(model, prompt, S, P, dev) - full)
                      .abs().max())
    out = {"drift": drift, "forced": None, "flips": 0, "routes": 0,
           "top": float(full.abs().max())}
    if full_routes:
        want = [r[:, :S] for r in full_routes] + [
            r[:, S + i:S + i + 1] for i in range(TEACHER_STEPS)
            for r in full_routes]
        for got, w in zip(own, want):
            same = (got[:, :w.shape[1]].sort(dim=-1).values
                    == w.sort(dim=-1).values).all(dim=-1)
            out["flips"] += int((~same).sum())
            out["routes"] += same.numel()
        with moe_routes(want):
            out["forced"] = float((teacher_forced(model, prompt, S, P, dev)
                                   - full).abs().max())
    return out


def serve_moe_ssm(args, dev, flush, arch, layers, want_params, want_active):
    """One engine of path 6: its parameter counts against the reference's
    and against what the engine holds; the run, every launch count set to
    0 just before it; the page table against a dict model, the launch
    counts (one fused GET a decode step, paged attention once per
    attention layer and step); every served token's logit against a full
    forward's row maximum; for the mamba models the prefill -> decode
    handoff in bf16 and, the engine freed, in f32; for olmoe ``moe_dense``
    against ``moe_ragged``; for the attention models the paged-attention
    kernel against its plain version at the engine's shapes and live
    lengths.  Returns (launches, paged-attention shape checks)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine, page_key

    cfg = get_config(arch)
    if layers:
        whole = cfg.param_count()
        cfg = dataclasses.replace(cfg, n_layers=layers)
        print(f"{arch}: cut to {layers} of {get_config(arch).n_layers} "
              f"layers (one superblock, {cfg.pattern!r}) at full widths: "
              f"the whole model's {whole} parameters take {2 * whole} B in "
              f"bf16, more than the card's memory")
    n_params, n_active = cfg.param_count(), cfg.active_param_count()
    check(n_params == want_params and n_active == want_active,
          f"{arch}: {n_params} parameters ({n_active} active) by the port's "
          f"schema, the reference counts {want_params} ({want_active})")
    kinds = tf.layer_kinds(cfg)
    attn_layers = cfg.n_superblocks * sum(k != "M" for k, _ in kinds)
    P, slots, new = SERVING_PAGE, SERVING_SLOTS, MOE_SSM_NEW_TOKENS
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_size=slots, max_seq=MOE_SSM_MAX_SEQ,
                        page_size=P, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sc.flatten(eng.model.params)
    held = sum(t.numel() for t in weights)
    check(held == n_params, f"{arch}: the engine holds {held} parameters, "
          f"the schema counts {n_params}")
    pool_bytes = {k: sum(t.numel() * t.element_size()
                         for c in eng.pools.values()
                         for n, t in c.items() if (n in tf.KV_LEAVES) == k)
                  for k in (True, False)}
    print(f"{arch}: {cfg.n_layers} layers {cfg.pattern!r}, d {cfg.d_model}, "
          f"{cfg.n_experts} experts top {cfg.top_k}, {attn_layers} attention "
          f"layers; {n_params} parameters, {n_active} active a token (the "
          f"reference's param_count() and active_param_count()), "
          f"{sum(t.numel() * t.element_size() for t in weights)} B of "
          f"weights drawn on the card in {init_s:.3f} s; KV pools "
          f"{eng.kv.n_pages} pages of {P} tokens, {pool_bytes[True]} B; "
          f"mamba states at {slots} slot rows, {pool_bytes[False]} B")

    rng = np.random.default_rng(args.seed)
    lo, hi = MOE_SSM_PROMPTS
    lens = [int(n) for n in rng.integers(lo, hi + 1, MOE_SSM_REQUESTS)]
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]

    # ---- the main path, every launch count set to 0 just before it -------
    torch.cuda.empty_cache()
    build.reset_launches()
    trace, live = None, []
    t0 = time.perf_counter()
    while True:
        steps = eng.stats["decode_steps"]
        if steps == MOE_SSM_TRACE_AT:
            trace = device_events(lambda: eng.run_until_done(max_ticks=3))
            for rid in rids[:slots]:        # live lengths, pages after it
                n = lens[rid] + MOE_SSM_TRACE_AT + 3
                live.append((n, [int.from_bytes(
                    eng.kv.table.get(page_key(rid, b)), "big")
                    for b in range(-(-n // P))]))
        else:
            eng.run_until_done(max_ticks=1)
        if eng.stats["decode_steps"] == steps:
            break
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    outs = eng.run_until_done()

    check(all(len(outs[r]) == new for r in rids),
          f"{arch}: a request did not return {new} tokens")
    check(eng.kv.pages_in_use == 1, f"{arch}: {eng.kv.pages_in_use} pages "
          f"in use after the run, not the scratch page alone")
    puts, deletes, left = page_table_model(rids, lens, P, new)
    st = eng.kv.table.stats
    check(not left and st.puts == puts and st.deletes == deletes,
          f"{arch}: page table puts/deletes {st.puts}/{st.deletes}, the "
          f"dict model {puts}/{deletes}")
    steps = eng.stats["decode_steps"]
    check(launches["fused_get"] == steps, f"{arch}: {launches['fused_get']} "
          f"fused GETs for {steps} decode steps")
    check(launches["paged_attention"] == attn_layers * steps,
          f"{arch}: {launches['paged_attention']} paged_attention launches "
          f"for {steps} decode steps of {attn_layers} attention layers")
    check(all(v == 0 for k, v in launches.items() if k not in
              ("paged_attention", "fused_get", "row_scatter")),
          f"{arch}: the serving path launched another kernel: {launches}")
    prefill_ms = [eng.prefill_s[r] * 1e3 for r in rids]
    decode_ms = [t * 1e3 for i, t in enumerate(eng.decode_s)
                 if not MOE_SSM_TRACE_AT <= i < MOE_SSM_TRACE_AT + 3]
    events, window_us = trace
    busy_us = sum(t for _, t in events)
    print(f"  served {len(rids)} requests in {slots} slots, prompts "
          f"{min(lens)}-{max(lens)} tokens (padded to {P}), {new} new "
          f"tokens each: {eng.stats['tokens']} tokens, {steps} decode steps "
          f"in {run_s:.3f} s, {eng.stats['tokens'] / run_s:.1f} tokens/s "
          f"(host clock)")
    print(f"  prefill per request (host clock, ms, prompt tokens): "
          + ", ".join(f"{m:.1f} ({n})" for m, n in zip(prefill_ms, lens)))
    print(f"  decode step (host clock, block-table GET batch of "
          f"{slots * eng.pps} keys, {cfg.n_layers} layers, {slots} slots): "
          f"median {statistics.median(decode_ms):.3f} ms, max "
          f"{max(decode_ms):.3f} ms over {len(decode_ms)} untraced steps")
    print(f"  device busy {busy_us / window_us:.4f} of 3 traced decode steps "
          f"({busy_us:.1f} of {window_us:.1f} us)")
    print_activities(events, f"{arch} decode steps")
    print(f"  page table: puts {st.puts}, deletes {st.deletes}, the dict "
          f"model's; launches {launches}")

    # ---- every served token against a plain full forward -----------------
    tol = MOE_SSM_TOL[arch]
    gap, agree, n = served_gap(eng.model, dict(zip(rids, prompts)), outs,
                               dev)
    print(f"  served tokens: the full forward's argmax equals {agree} of "
          f"{n} (floor {tol['agree']:.4f} of them); largest gap between a "
          f"served token's logit and its row's max {gap:.4f} (tolerance "
          f"{tol['gap']})")
    check(gap <= tol["gap"], f"{arch}: a served token's logit lies "
          f"{gap:.4f} below its row's max in the full forward")
    check(agree >= tol["agree"] * n, f"{arch}: {agree} of {n} served "
          f"tokens are the full forward's argmax")

    shapes = []
    if attn_layers:
        shapes.append(paged_engine_check(arch, eng, cfg, live, args, dev,
                                         flush))
    if arch == MOE_IMPL_ARCH:
        moe_impl_check(eng, cfg, args, dev)
    rid = int(np.argmax(lens))
    mamba = any(k == "M" for k, _ in kinds)
    if mamba:
        h = handoff_drift(eng.model, prompts[rid], P, dev)
        held = h["drift"] if h["forced"] is None else h["forced"]
        diff = f"{h['drift']:.4f} (tolerance {tol['handoff']})" \
            if h["forced"] is None else (
                f"with its own routes {h['drift']:.4f} (tolerance "
                f"{MOE_OWN_ROUTES_TOL}; {h['flips']} of {h['routes']} (MoE "
                f"layer, position) routes flipped against the full "
                f"forward's), with every route forced to the full forward's "
                f"{h['forced']:.4f} (tolerance {tol['handoff']})")
        print(f"  handoff, request {rid} ({lens[rid]} prompt tokens), bf16: "
              f"prefill of all but {TEACHER_STEPS} tokens + {TEACHER_STEPS} "
              f"teacher-forced decode steps vs the full forward's logits "
              f"(|logit| up to {h['top']:.2f}): max abs diff {diff}")
        check(held <= tol["handoff"], f"{arch}: handoff logits differ from "
              f"the full forward by {held:.4f}")
        check(h["drift"] <= MOE_OWN_ROUTES_TOL, f"{arch}: handoff logits "
              f"with its own routes differ from the full forward by "
              f"{h['drift']:.4f}")
    del eng, weights
    gc.collect()
    torch.cuda.empty_cache()
    if mamba:       # the same handoff with f32 weights, the engine freed
        schema32 = sc.map_tree(lambda d: dataclasses.replace(
            d, dtype=torch.float32), tf.schema(cfg))
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = tf.Transformer(cfg, sc.init(schema32, gen, dev))
        h = handoff_drift(model, prompts[rid], P, dev)
        print(f"  handoff, request {rid}, f32 weights drawn on the card: "
              f"max abs diff {h['drift']:.6f} (|logit| up to "
              f"{h['top']:.2f}; tolerance {F32_TOL}; "
              f"{h['flips']} of {h['routes']} routes flipped)")
        check(h["drift"] <= F32_TOL, f"{arch}: f32 handoff logits "
              f"differ from the full forward by {h['drift']:.6f}")
        if not attn_layers:     # the slot rows through an f32 engine
            eng = ServingEngine(cfg, model.params, batch_size=slots,
                                max_seq=MOE_SSM_MAX_SEQ, page_size=P,
                                device=dev)
            rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
            outs = eng.run_until_done()
            gap, agree, n = served_gap(eng.model, dict(zip(rids, prompts)),
                                       outs, dev)
            print(f"  served tokens of the same prompts through an engine "
                  f"with these f32 weights: the full forward's argmax "
                  f"equals {agree} of {n}; largest gap between a served "
                  f"token's logit and its row's max {gap:.6f} (tolerance "
                  f"{F32_TOL})")
            check(gap <= F32_TOL, f"{arch}: an f32 engine's served token "
                  f"lies {gap:.6f} below its row's max")
            del eng
        del model
    return launches, shapes


def moe_impl_check(eng, cfg, args, dev) -> None:
    """``moe_dense`` against ``moe_ragged`` on the engine's first MoE
    layer, its weights cast to f32, on a decode batch (one token a slot)
    and on a prefill of MOE_PREFILL_TOKENS tokens of seeded normal inputs
    (an RMS-normed hidden state's scale); both timed by CUDA events.
    First, the peak allocation of one bf16 ``moe_dense`` decode call on
    the layer's own weights must stay under one expert weight tensor's
    bytes: the products read the weights where they lie."""
    from repro_torch.models import moe as me
    from repro_torch.models import transformer as tf
    j = next(i for i, (_, f) in enumerate(tf.layer_kinds(cfg)) if f == "moe")
    ffn = eng.model.params["blocks"][f"l{j}"]["ffn"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p16 = {k: t[0] for k, t in ffn.items()}
    x = torch.randn(SERVING_SLOTS, 1, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    me.moe_dense(p16, x, cfg)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    weight = p16["w_gate"].numel() * p16["w_gate"].element_size()
    print(f"  moe_dense, layer l{j} in bf16, decode {SERVING_SLOTS} tokens: "
          f"peak allocation {rise} B above its inputs, one expert weight "
          f"tensor {list(p16['w_gate'].shape)} {weight} B")
    check(rise < weight, f"moe_dense allocates {rise} B a decode call, as "
          f"much as a copy of its {weight} B expert weights")
    p = {k: t[0].float() for k, t in ffn.items()}
    for name, shape in (("decode", (SERVING_SLOTS, 1)),
                        ("prefill", (1, MOE_PREFILL_TOKENS))):
        x = torch.randn(*shape, cfg.d_model, generator=gen, device=dev)
        dense, ragged = me.moe_dense(p, x, cfg), me.moe_ragged(p, x, cfg)
        err = float((dense - ragged).abs().max())
        try:
            torch.testing.assert_close(ragged, dense, **MOE_IMPL_TOL)
        except AssertionError as exc:
            raise SmokeFailure(f"moe_ragged vs moe_dense ({name}): {exc}")
        reps = 20 if name == "decode" else 5
        dense_ms = cuda_ms([lambda: me.moe_dense(p, x, cfg)], reps)
        ragged_ms = cuda_ms([lambda: me.moe_ragged(p, x, cfg)], reps)
        print(f"  moe_dense vs moe_ragged, layer l{j} in f32, {name} "
              f"{list(shape)} tokens: max abs diff {err:.3g} (tolerance "
              f"rtol {MOE_IMPL_TOL['rtol']}, atol {MOE_IMPL_TOL['atol']}; "
              f"|out| up to {float(dense.abs().max()):.3f}); dense "
              f"{dense_ms:.4f} ms, ragged {ragged_ms:.4f} ms a call (CUDA "
              f"events, back to back; the ragged one reads its group "
              f"sizes back)")
        del x, dense, ragged


def paged_engine_check(arch, eng, cfg, live, args, dev, flush) -> dict:
    """The paged-attention kernel against its plain version on the
    engine's first attention layer's live pool, at the engine's shapes
    and the live lengths after the traced steps (``paged_pool_check``)."""
    from repro_torch.models import transformer as tf
    j = next(i for i, (k, _) in enumerate(tf.layer_kinds(cfg)) if k != "M")
    bt = torch.zeros(SERVING_SLOTS, eng.pps, dtype=torch.int32)
    for i, (_, pages) in enumerate(live):
        bt[i, :len(pages)] = torch.tensor(pages)
    sl = torch.tensor([n for n, _ in live], dtype=torch.int32, device=dev)
    return paged_pool_check(f"the {arch} engine's", f"{arch} engine", cfg,
                            eng.pools[f"l{j}"], bt.to(dev), sl, args, dev,
                            flush)


def paged_pool_check(what, name, cfg, pools, bt, sl, args, dev,
                     flush) -> dict:
    """The paged-attention kernel against its plain version on one
    layer's live pools (``pools["k_pages"][0]``, its first superblock),
    block tables ``bt`` and live lengths ``sl``, in bf16 and f32 with the
    serving check's tolerances; its device time (L2 flushed), time per
    call through the wrapper, the plain version's time, SDPA over the
    gathered K/V (a partial yardstick) and the byte bound.  Returns the
    entry for the ``kernels`` line's ``shapes``, named ``name``."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention, ref
    slots, pps = bt.shape
    P = pools["k_pages"].shape[2]
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp = pools["k_pages"][0]
    vp = pools["v_pages"][0]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q = torch.randn(slots, H, D, generator=gen, device=dev) \
        .to(torch.bfloat16)
    scale = D ** -0.5
    err = 0.0
    for dtype, tol in ((torch.bfloat16, dict(rtol=2 ** -7, atol=1e-6)),
                       (torch.float32, dict(rtol=1e-5, atol=1e-5))):
        a = (q.to(dtype), kp.to(dtype), vp.to(dtype), bt, sl)
        got = paged_attention.paged_attention(*a, scale=scale)
        want = ref.paged_attention_ref(*a, scale=scale)
        try:
            torch.testing.assert_close(got, want, **tol)
        except AssertionError as exc:
            raise SmokeFailure(f"paged_attention at {what} shape "
                               f"({dtype}) vs plain: {exc}")
        err = max(err, float((got.float() - want.float()).abs().max()))
        del a, got, want
    call = [lambda: paged_attention.paged_attention(q, kp, vp, bt, sl,
                                                    scale=scale)]
    ms = device_ms(call, 64, "paged_attention_kernel", flush, per_call=2)
    wrapper_ms = cuda_ms(call, 200)
    plain_ms = cuda_ms([lambda: ref.paged_attention_ref(q, kp, vp, bt, sl,
                                                        scale=scale)], 16)
    kd = kp[bt.long()].reshape(slots, -1, KVH, D).transpose(1, 2) \
        .contiguous()
    vd = vp[bt.long()].reshape(slots, -1, KVH, D).transpose(1, 2) \
        .contiguous()
    mask = (torch.arange(kd.shape[2], device=dev)[None, :]
            < sl[:, None])[:, None, None, :]
    library_ms = device_all_ms([lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask, scale=scale,
        enable_gqa=True)], 64, flush)
    live_pos = int(sl.sum())
    pages = int((-(-sl.long() // P)).sum())     # each live page id read
    io = live_pos * KVH * D * 2 * kp.element_size() \
        + 2 * q.numel() * q.element_size() + 4 * (pages + 2 * slots)
    ops_ = 4 * H * D * live_pos
    bytes_ms = io / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    plan = paged_attention.span_plan(slots, H, KVH, pps, P, D, kp.dtype)
    print(f"  paged_attention at {what} shape (B = {slots}, H "
          f"= {H}, KVH = {KVH}, G = {H // KVH}, D = {D}, P = {P}, PPS = "
          f"{pps}, bf16, live lengths {sl.tolist()}): equals its plain "
          f"version in bf16 and f32 (max abs err {err:.3g}); plan "
          f"{plan._asdict()}; kernel {ms:.4f} ms device time (L2 flushed), "
          f"{wrapper_ms:.4f} ms per call through the wrapper, plain "
          f"{plain_ms:.4f} ms, SDPA over the gathered K/V {library_ms:.4f} "
          f"ms device time; bound {bound_ms:.6f} ms ({io} B; {ops_} flops "
          f"take {ops_ms:.6f} ms)")
    return {"name": name, "G": H // KVH, "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def encdec_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """Path 7's seeded inputs for ``prefill_step``: an embedding-input
    model's ``embeds`` [B, S, d] (the pixtral-ViT frontend is a stub in
    the reference too), else ``tokens`` [B, S]; an encoder-decoder
    model's ``enc_embeds`` [B, S // enc_seq_divisor, d] (the audio
    frontend's frames, a stub too).  Embeddings are N(0, sigma^2) in
    bf16, sigma = vocab ** -0.5, the scale ``schema.init`` gives the
    ``embed`` table; tokens uniform in [1, vocab)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sigma = cfg.vocab ** -0.5

    def emb(n):
        return (torch.randn(B, n, cfg.d_model, generator=gen, device=dev)
                * sigma).to(torch.bfloat16)
    batch = {}
    if cfg.embeds_in:
        batch["embeds"] = emb(S)
    else:
        batch["tokens"] = torch.randint(1, cfg.vocab, (B, S), generator=gen,
                                        device=dev, dtype=torch.int32)
    if cfg.n_enc_layers:
        batch["enc_embeds"] = emb(S // cfg.enc_seq_divisor)
    return batch


def decode_room(cache, cfg, seq_len: int, dev):
    """Prefill's caches (B sequences of pps pages, identity block tables)
    moved into pools of ``launch/steps.decode_cache_abstract``'s shapes
    for a decode ``ShapeConfig`` of ``seq_len`` and batch B, in prefill's
    dtype: sequence b's pages become pages b * room .. b * room + pps - 1
    (room = seq_len // P), under identity block tables, lengths kept.
    (Smoke code: the package's engine allocates pages through its page
    table.)"""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ShapeConfig
    B, pps = cache.block_tables.shape
    P = next(iter(cache.layers.values()))["k_pages"].shape[2]
    spec = steps.decode_cache_abstract(
        cfg, ShapeConfig("encdec", "decode", seq_len, B, P))
    room = spec.block_tables.shape[1]
    layers = {}
    for name, c in cache.layers.items():
        layers[name] = {}
        for kind, t in c.items():
            big = torch.zeros(spec.layers[name][kind].shape, dtype=t.dtype,
                              device=dev)
            big.view(t.shape[0], B, room, *t.shape[2:])[:, :, :pps] = \
                t.view(t.shape[0], B, pps, *t.shape[2:])
            layers[name][kind] = big
    bt = torch.arange(B * room, dtype=torch.int32, device=dev).view(B, room)
    return tf.DecodeCache(layers, bt, cache.seq_lens.clone())


def serve_encdec(model, batch: dict, P: int, seq_len: int, new: int, dev,
                 trace_at=None) -> dict:
    """Path 7's main path through ``launch/steps.py``: ``prefill_step``
    (the encoder, then prefill from tokens or embeddings with its
    output), the caches moved into decode pools (``decode_room``), and
    ``new - 1`` greedy ``decode_step``s against the request's own
    ``enc_out``; steps ``trace_at`` .. ``trace_at + 2`` under the
    profiler.  Returns {"served" [B, new], "logits" of the decode steps
    [new - 1, B, V], "cache", "enc_out", "first" (prefill's logits),
    "prefill_s", "step_s" (host clock, each ending in a sync), "trace"}."""
    from repro_torch.launch import steps
    sync(dev)
    t0 = time.perf_counter()
    first, cache, enc_out = steps.prefill_step(model, batch, P)
    sync(dev)
    out = {"prefill_s": time.perf_counter() - t0, "enc_out": enc_out,
           "first": first, "step_s": [], "trace": None}
    cache = decode_room(cache, model.cfg, seq_len, dev)
    served, rows = [first.argmax(dim=-1)], []

    def step():
        nonlocal cache
        lg, cache = steps.decode_step(model, cache, served[-1][:, None], P,
                                      enc_out=enc_out)
        rows.append(lg)
        served.append(lg.argmax(dim=-1))
    while len(served) < new:
        if len(rows) == trace_at:
            out["trace"] = device_events(lambda: [step() for _ in range(3)])
            continue
        t0 = time.perf_counter()
        step()
        sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
    out.update(served=torch.stack(served, dim=1), logits=torch.stack(rows),
               cache=cache)
    return out


def replay_encdec(model, cache, served, P: int, enc_out, attn=None):
    """Decode steps from ``cache`` (its lengths at the prompt's) fed the
    served tokens but the last, through ``attn``: the steps of
    ``serve_encdec`` again when given its pools with their lengths set
    back (each step rewrites its position before reading it).  Returns
    their logits [new - 1, B, V]."""
    from repro_torch.launch import steps
    c, rows = cache, []
    for i in range(served.shape[1] - 1):
        lg, c = steps.decode_step(model, c, served[:, i:i + 1], P,
                                  enc_out=enc_out, attn=attn)
        rows.append(lg)
    return torch.stack(rows)


def encdec_full(model, batch: dict, served, enc_out, b: int):
    """A plain full forward's logits [new, V] for sequence b over its
    prompt and the tokens served before the last, cross-attending to its
    ``enc_out`` where there is one: an embedding-input model takes
    ``cat(prompt embeddings, embed[served[:-1]])`` (decode embeds
    tokens)."""
    S = next(v for k, v in batch.items() if k in ("embeds", "tokens")) \
        .shape[1]
    fed = served[b, :-1]
    eo = None if enc_out is None else enc_out[b:b + 1]
    if "embeds" in batch:
        rows = model.params["embed"][fed.long()]
        e = torch.cat([batch["embeds"][b].to(rows.dtype), rows])
        return model(embeds=e[None], enc_out=eo)[0, S - 1:]
    toks = torch.cat([batch["tokens"][b], fed.to(batch["tokens"].dtype)])
    return model(toks[None], enc_out=eo)[0, S - 1:]


def encdec_gap(model, batch: dict, served, enc_out) -> tuple:
    """Every served token against a plain full forward, one sequence at
    a time (``encdec_full``): (largest gap between a served token's logit
    and its row's maximum, served tokens that are the forward's argmax,
    served tokens)."""
    gap, agree = 0.0, 0
    for b in range(served.shape[0]):
        logits = encdec_full(model, batch, served, enc_out, b)
        rows = torch.arange(served.shape[1], device=logits.device)
        chosen = logits[rows, served[b].long()]
        gap = max(gap, float((logits.max(dim=-1).values - chosen).max()))
        agree += int((logits.argmax(dim=-1) == served[b]).sum())
        del logits
    return gap, agree, served.numel()


def encdec_f32_drift(model, batch: dict, served, P: int, seq_len: int,
                     dev) -> float:
    """With ``model``'s f32 weights: prefill + decode steps fed the served
    tokens (``replay_encdec`` on f32 pools) against the f32 full forward
    over the same tokens with the model's own ``enc_out``: the largest
    absolute logit difference."""
    from repro_torch.launch import steps
    first, cache, enc_out = steps.prefill_step(model, batch, P)
    cache = decode_room(cache, model.cfg, seq_len, dev)
    rows = torch.cat([first[None], replay_encdec(model, cache, served, P,
                                                 enc_out)])
    drift = 0.0
    for b in range(served.shape[0]):
        full = encdec_full(model, batch, served, enc_out, b)
        drift = max(drift, float((rows[:, b] - full).abs().max()))
    return drift


def encdec_serving_path(args, dev, flush):
    """Path 7: pixtral-12b and seamless-m4t-medium at full widths and
    depth, random bf16 weights from ``--seed``, one after another, each
    prefilled and decoded through ``launch/steps.py``
    (``serve_encdec``).  Returns the launch counts summed over both runs
    and the paged-attention kernel's checks at their shapes."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory before path 7: {torch.cuda.memory_allocated()} B "
          f"allocated; peak of the run so far "
          f"{torch.cuda.max_memory_allocated()} B")
    torch.cuda.reset_peak_memory_stats()
    launches, shapes = collections.Counter(), []
    for arch, want in ENCDEC_MODELS:
        t0 = time.perf_counter()
        counts, shape = serve_encdec_model(args, dev, flush, arch, want)
        launches.update(counts)
        shapes.append(shape)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {arch}: {time.perf_counter() - t0:.3f} s with its checks "
              f"and timings")
    print(f"  path 7's peak allocation {torch.cuda.max_memory_allocated()} B")
    return launches, shapes


def serve_encdec_model(args, dev, flush, arch, want_params):
    """One model of path 7: its parameter count against the reference's
    and what the model holds; ``serve_encdec`` with every launch count
    set to 0 just before it; the launch counts (paged attention once per
    layer and decode step, no other kernel); ``enc_out``'s shape and
    finiteness; every served token against a plain full forward; the same
    decode steps through the plain attention; for seamless, the f32
    handoff; the kernel against its plain version at the model's shape
    and live lengths.  Returns (launches, the kernel's shape check)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf

    cfg = get_config(arch)
    n_params = cfg.param_count()
    check(n_params == want_params, f"{arch}: {n_params} parameters by the "
          f"port's schema, the reference counts {want_params}")
    B, S, P, new = ENCDEC_BATCH, ENCDEC_PROMPT, SERVING_PAGE, ENCDEC_NEW
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = tf.Transformer(cfg, sc.init(tf.schema(cfg), gen, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sc.flatten(model.params)
    held = sum(t.numel() for t in weights)
    check(held == n_params, f"{arch}: the model holds {held} parameters, "
          f"the schema counts {n_params}")
    batch = encdec_batch(cfg, B, S, args.seed, dev)
    print(f"{arch}: {cfg.n_layers} decoder layers, {cfg.n_enc_layers} "
          f"encoder layers, d {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads, head {cfg.head_dim}, vocab "
          f"{cfg.vocab}; {n_params} parameters (the reference's "
          f"param_count()), {sum(t.numel() * t.element_size() for t in weights)}"
          f" B of bf16 weights drawn on the card in {init_s:.3f} s; inputs "
          + ", ".join(f"{k} {list(v.shape)} {v.dtype}"
                      for k, v in batch.items()))

    # ---- the main path, every launch count set to 0 just before it -------
    torch.cuda.empty_cache()
    build.reset_launches()
    t0 = time.perf_counter()
    run = serve_encdec(model, batch, P, ENCDEC_SEQ, new, dev,
                       trace_at=ENCDEC_TRACE_AT)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    cache, enc_out, served = run["cache"], run["enc_out"], run["served"]
    steps_n = new - 1
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in sc.flatten(cache.layers))
    check(launches["paged_attention"] == cfg.n_layers * steps_n,
          f"{arch}: {launches['paged_attention']} paged_attention launches "
          f"for {steps_n} decode steps of {cfg.n_layers} layers")
    check(all(v == 0 for k, v in launches.items() if k != "paged_attention"),
          f"{arch}: path 7 launched another kernel: {launches}")
    check(served.shape == (B, new) and bool(
        (cache.seq_lens == S + steps_n).all()),
          f"{arch}: served {list(served.shape)}, lengths "
          f"{cache.seq_lens.tolist()}")
    if cfg.n_enc_layers:
        frames = S // cfg.enc_seq_divisor
        check(enc_out.shape == (B, frames, cfg.d_model)
              and bool(torch.isfinite(enc_out).all()),
              f"{arch}: enc_out {list(enc_out.shape)}, finite "
              f"{bool(torch.isfinite(enc_out).all())}")
        print(f"  encode: enc_out {list(enc_out.shape)} {enc_out.dtype}, "
              f"finite, |x| up to {float(enc_out.abs().max()):.3f}")
    events, window_us = run["trace"]
    busy_us = sum(t for _, t in events)
    step_ms = [t * 1e3 for t in run["step_s"]]
    print(f"  prefill of {B} x {S} positions through steps.prefill_step "
          f"{run['prefill_s'] * 1e3:.1f} ms (host clock, the encoder "
          f"included); {steps_n} decode steps through steps.decode_step in "
          f"{run_s:.3f} s with the prefill; decode step median "
          f"{statistics.median(step_ms):.3f} ms, max {max(step_ms):.3f} ms "
          f"over {len(step_ms)} untraced steps (host clock); device busy "
          f"{busy_us / window_us:.4f} of 3 traced decode steps "
          f"({busy_us:.1f} of {window_us:.1f} us); decode pools "
          f"{pool_bytes} B; launches {launches}")
    print_activities(events, f"{arch} decode steps")

    # ---- the served tokens against a plain full forward -----------------
    tol = ENCDEC_TOL[arch]
    gap, agree, n = encdec_gap(model, batch, served, enc_out)
    print(f"  served tokens: the full forward's argmax equals {agree} of {n} "
          f"(floor {tol['agree']:.4f} of them); largest gap between a "
          f"served token's logit and its row's max {gap:.4f} (tolerance "
          f"{tol['gap']})")
    check(gap <= tol["gap"], f"{arch}: a served token's logit lies "
          f"{gap:.4f} below its row's max in the full forward")
    check(agree >= tol["agree"] * n, f"{arch}: {agree} of {n} served "
          f"tokens are the full forward's argmax")
    plain = replay_encdec(model, cache._replace(
        seq_lens=cache.seq_lens - steps_n), served, P, enc_out,
        attn=ref.paged_attention_ref)
    between = float((plain - run["logits"]).abs().max())
    print(f"  the same {steps_n} decode steps through the plain attention: "
          f"max abs diff to the kernel's logits {between:.4f} (tolerance "
          f"{tol['gap']})")
    check(between <= tol["gap"], f"{arch}: decode logits through the kernel "
          f"and through the plain attention differ by {between:.4f}")
    del plain, run

    bt = cache.block_tables
    shape = paged_pool_check(f"{arch}'s", arch, cfg, cache.layers["l0"], bt,
                             cache.seq_lens, args, dev, flush)
    del cache, model, weights
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.n_enc_layers:    # the same inputs with f32 weights
        schema32 = sc.map_tree(lambda d: dataclasses.replace(
            d, dtype=torch.float32), tf.schema(cfg))
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = tf.Transformer(cfg, sc.init(schema32, gen, dev))
        drift = encdec_f32_drift(model, batch, served, P, ENCDEC_SEQ, dev)
        print(f"  f32 weights drawn on the card: prefill + {steps_n} decode "
              f"steps fed the served tokens vs the f32 full forward: max "
              f"abs diff {drift:.6f} (tolerance {ENCDEC_F32_TOL})")
        check(drift <= ENCDEC_F32_TOL, f"{arch}: f32 prefill + decode "
              f"logits differ from the full forward by {drift:.6f}")
        del model
    return launches, shape


def training_path(args, dev, card: str):
    """Path 8: the one-device training path, run after path 7's models
    are freed.  (a) qwen2.5-3b at full widths and depth (random bf16
    weights from ``--seed``) trained ``TRAIN_STEPS`` steps by
    ``TrainLoop`` over ``steps.train_step`` with ``TRAIN_ACCUM``
    microbatches of 1 x 4,096 tokens (remat on) from ``SyntheticSource``,
    every launch count set to 0 just before the loop; (b) the loss and
    every gradient leaf on the card against the port's own CPU run, and
    ``remat=False`` against ``remat=True`` on the card
    (``train_card_vs_cpu``); (c) the restart drill, the checkpoint
    catalog and the example (``restart_drill``).  Returns the launch
    counts of (a)'s loop and (c)'s drill summed, each window opened with
    every count set to 0; all must be 0, since the training path runs no
    kernel of the port and the checkpoint catalog uses the store's host
    operations only."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory before path 8: {torch.cuda.memory_allocated()} B "
          f"allocated; peak of the run so far "
          f"{torch.cuda.max_memory_allocated()} B")
    t0 = time.perf_counter()
    launches = train_full_size(args, dev, card)
    print(f"  full-size training with its checks: "
          f"{time.perf_counter() - t0:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_card_vs_cpu(args, dev)
    print(f"  card against CPU: {time.perf_counter() - t0:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    drill = restart_drill(args, dev)
    print(f"  restart drill and example: {time.perf_counter() - t0:.3f} s")
    return {k: v + drill[k] for k, v in launches.items()}


def train_full_size(args, dev, card: str) -> dict:
    """Path 8 (a).  Checks: the parameter count is the reference's, every
    logged loss and gnorm is finite, the parameters moved, no kernel of
    the port launched.  Prints, as figures and not claims: each step's
    loss, gnorm and host-clock time, tokens/s and step time over the steps
    after the first, the peak allocation, the device's busy share of one
    more step traced by the profiler, and 6 * N * tokens per step over the
    step time against the card's dense bf16 peak, N without the embedding
    table (a lookup, no product; ``lm_head`` is a leaf of its own and
    counts), with attention's own products and the recompute left out of
    the numerator too."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_loop import LoopConfig, TrainLoop

    cfg = get_config(TRAIN_ARCH)
    n_params = cfg.param_count()
    check(n_params == QWEN_PARAMS, f"{TRAIN_ARCH}: {n_params} parameters by "
          f"the port's schema, the reference counts {QWEN_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = sc.init(tf.schema(cfg), gen, dev)
    state = opt.init(params)
    sync(dev)
    held = sum(t.numel() for t in sc.flatten(params))
    check(held == n_params, f"{TRAIN_ARCH}: {held} parameters held")
    state_b = sum(t.numel() * t.element_size()
                  for t in sc.flatten((params, state)))
    print(f"{TRAIN_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}; {n_params} bf16 parameters and their f32 AdamW "
          f"moments ({state_b} B) drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s; global batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} (train_4k's 256 cut to {TRAIN_BATCH}), "
          f"{TRAIN_ACCUM} microbatches, remat on")
    probe = [params["lm_head"][:64, :64], params["embed"][:64, :64],
             params["blocks"]["l0"]["attn"]["wq"][-1, :64, :64],
             params["final_norm"]["scale"]]
    before = [t.detach().clone() for t in probe]
    opt_cfg = opt.AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS + 1)

    def step_fn(p, o, b):
        return steps.train_step(p, o, b, cfg, opt_cfg, accum=TRAIN_ACCUM)
    pipe = DataPipeline(SyntheticSource(cfg.vocab, seed=args.seed),
                        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    with tempfile.TemporaryDirectory() as tmp:
        loop = TrainLoop(step_fn, params, state, pipe,
                         CheckpointManager(tmp, device=dev),
                         LoopConfig(total_steps=TRAIN_STEPS,
                                    ckpt_every=10 ** 9,
                                    log_every=1))
        try:
            # ---- the main path, every launch count set to 0 just before
            build.reset_launches()
            t0 = time.perf_counter()
            loop.run()
            run_s = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            events, window_us = device_events(lambda: loop.run(steps=1))
        finally:
            pipe.close()
        check(loop.ckpt.all_steps() == [], "a full-size checkpoint was saved")
    log = loop.metrics_log
    for m in log:
        print(f"  step {m['step']}: loss {m['loss']:.4f}, gnorm "
              f"{m['gnorm']:.4f}, {m['step_time_s'] * 1e3:.1f} ms (host "
              f"clock), starvations {m['starvations']}")
    check(len(log) == TRAIN_STEPS + 1 and all(
        np.isfinite(m["loss"]) and np.isfinite(m["gnorm"]) for m in log),
        f"{TRAIN_ARCH}: losses and gnorms {log}")
    moved = [float((a.float() - b.detach().float()).abs().max())
             for a, b in zip(before, probe)]
    check(all(x > 0 for x in moved), f"parameters did not move: {moved}")
    check(not any(launches.values()), f"path 8 launched a kernel of the "
          f"port: {launches}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    later = [m["step_time_s"] for m in log[1:TRAIN_STEPS]]
    step_s = statistics.median(later)
    busy_us = sum(t for _, t in events)
    n_matmul = n_params - params["embed"].numel()
    flops = 6 * n_matmul * tokens
    print(f"  {TRAIN_STEPS} steps in {run_s:.3f} s; first step "
          f"{log[0]['step_time_s'] * 1e3:.1f} ms; median of steps 2-"
          f"{TRAIN_STEPS} {step_s * 1e3:.1f} ms (host clock), "
          f"{tokens / step_s:.1f} tokens/s; peak allocation {peak} B of "
          f"{torch.cuda.get_device_properties(0).total_memory} B; device busy "
          f"{busy_us / window_us:.4f} of one traced step ({busy_us:.1f} of "
          f"{window_us:.1f} us, {len(events)} device activities); "
          f"6*N*tokens (N = {n_matmul} without the embedding) = "
          f"{flops:.4e} FLOP a step, {flops / step_s / 1e12:.2f} "
          f"TFLOP/s, {flops / step_s / BF16_FLOPS:.4f} of the dense bf16 "
          f"peak; parameters moved by up to {max(moved):.3e}; launches "
          f"{launches}; card {card}")
    print_activities(events, f"{TRAIN_ARCH} training step", top=8)
    print(json.dumps({"training": {
        "arch": TRAIN_ARCH, "params": n_params,
        "params_without_embedding": n_matmul, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "accum": TRAIN_ACCUM, "steps": TRAIN_STEPS,
        "losses": [m["loss"] for m in log],
        "gnorms": [m["gnorm"] for m in log],
        "step_ms": [m["step_time_s"] * 1e3 for m in log],
        "median_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "peak_allocated_bytes": peak,
        "busy_share": busy_us / window_us,
        "model_flops_share": flops / step_s / BF16_FLOPS, "card": card}}))
    del loop, params, state, probe, before
    return launches


def train_card_vs_cpu(args, dev) -> None:
    """Path 8 (b): qwen2.5-3b at full widths cut to ``TRAIN_CHECK_LAYERS``
    layers, f32 weights drawn on the host, 1 x ``TRAIN_CHECK_TOKENS``
    tokens whose labels hold -1s: ``steps.loss_and_grads`` on the card
    against the same on the CPU, and on the card with ``remat=False``
    against ``remat=True``; the loss and every gradient leaf within
    ``TRAIN_CHECK_TOL`` of the leaf's largest magnitude (TF32 off: the
    card's f32 products in full f32)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CHECK_LAYERS)
    schema32 = sc.map_tree(lambda d: dataclasses.replace(
        d, dtype=torch.float32), tf.schema(cfg))
    params = sc.init(schema32, torch.Generator().manual_seed(args.seed),
                     "cpu")
    rng = np.random.default_rng(args.seed)
    S = TRAIN_CHECK_TOKENS
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, S)).astype(np.int32)),
        "labels": torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, S)).astype(np.int32))}
    batch["labels"][0, :S // 8] = -1
    batch["labels"][0, -1] = -1
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        cpu = steps.loss_and_grads(params, cfg, batch)
        cpu_s = time.perf_counter() - t0
        on_card = sc.map_tree(lambda t: t.detach().to(dev), params)
        card_b = {k: v.to(dev) for k, v in batch.items()}
        runs = {}
        for remat in (True, False):
            torch.cuda.reset_peak_memory_stats()
            sync(dev)
            t0 = time.perf_counter()
            loss, grads = steps.loss_and_grads(on_card, cfg, card_b,
                                               remat=remat)
            sync(dev)
            runs[remat] = (loss, grads, time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow

    def worst(want, got) -> float:
        return max(float((a.to(dev) - b).abs().max())
                   / max(float(a.abs().max()), 1e-30)
                   for a, b in zip(want, got))
    loss_cpu, grads_cpu = cpu
    loss_card, grads_card, card_s, _ = runs[True]
    vs_cpu = worst(grads_cpu, grads_card)
    vs_remat = worst(grads_card, runs[False][1])
    loss_err = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    bitwise = all(torch.equal(a, b) for a, b in zip(grads_card,
                                                    runs[False][1]))
    print(f"  {TRAIN_ARCH} at full widths, {TRAIN_CHECK_LAYERS} layers, f32, "
          f"1 x {S} tokens ({int((batch['labels'] < 0).sum())} labels -1): "
          f"loss {float(loss_card):.6f} on the card, {float(loss_cpu):.6f} "
          f"on the CPU (relative {loss_err:.2e}); worst gradient leaf "
          f"{vs_cpu:.2e} of its max against the CPU, remat=False against "
          f"remat=True {vs_remat:.2e} (bit for bit: {bitwise}); tolerance "
          f"{TRAIN_CHECK_TOL}; {len(grads_card)} leaves; card "
          f"{card_s * 1e3:.1f} ms with remat ({runs[True][3]} B peak), "
          f"{runs[False][2] * 1e3:.1f} ms without ({runs[False][3]} B "
          f"peak); CPU {cpu_s:.3f} s")
    check(loss_err <= TRAIN_CHECK_TOL, f"card loss {float(loss_card)} vs "
          f"CPU {float(loss_cpu)}")
    check(vs_cpu <= TRAIN_CHECK_TOL, f"card gradients vs CPU: {vs_cpu:.3e}")
    check(abs(float(runs[False][0]) - float(loss_card))
          <= TRAIN_CHECK_TOL * abs(float(loss_card))
          and vs_remat <= TRAIN_CHECK_TOL,
          f"remat=False vs remat=True on the card: {vs_remat:.3e}")


def restart_drill(args, dev) -> dict:
    """Path 8 (c), at examples/torch_train_lm.py's size (4 layers, d 128,
    d_ff 256, vocab 512, batch 16 x 64) under
    ``torch.use_deterministic_algorithms(True)`` (the embedding's and the
    gather's backward accumulate by sorting, not by atomics): 20 steps
    straight with a checkpoint every 10, against 10 steps, then a fresh
    loop that ``restore_latest()``s and runs 10 more; every leaf of the
    parameters and the optimizer state must be equal bit for bit.
    ``CUBLAS_WORKSPACE_CONFIG`` is set for the phase because deterministic
    mode refuses cuBLAS calls without it, but the cuBLAS handles that
    paths 4-7 made keep the workspace they were given: the products'
    bit equality between the runs is observed on the card, not
    guaranteed by the variable.  The catalog's
    ``all_steps``, ``latest_step`` at every step 0-25 and its retention
    (keep 2) against a dict model; a checkpoint restored from the card
    equals the leaves it saved bit for bit.  Every launch count is set to
    0 just before the three loops and read after the catalog's checks;
    returns those counts.  Last, the example runs as a subprocess and must
    print LEARNING."""
    import os
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.models import schema as sc
    from repro_torch.train.train_loop import LoopConfig, build_smoke_loop
    cfg = dataclasses.replace(get_smoke_config("qwen2p5_3b"), n_layers=4,
                              d_model=128, d_ff=256, vocab=512)
    lc = LoopConfig(total_steps=DRILL_STEPS, ckpt_every=DRILL_STEPS // 2,
                    log_every=5)
    env_was = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def loop(name, seed=args.seed):
                return build_smoke_loop(cfg, batch=16, seq=64,
                                        ckpt_dir=Path(tmp) / name,
                                        loop_cfg=lc, device=dev, seed=seed)
            build.reset_launches()
            t0 = time.perf_counter()
            a = loop("a")
            try:
                a.run()
            finally:
                a.pipeline.close()
            b = loop("b")
            try:
                b.run(steps=DRILL_STEPS // 2)
            finally:
                b.pipeline.close()
            c = loop("b", seed=args.seed + 1)
            try:
                check(c.restore_latest() and c.step == DRILL_STEPS // 2,
                      f"restore_latest gave step {c.step}")
                c.run(steps=DRILL_STEPS // 2)
            finally:
                c.pipeline.close()
            drill_s = time.perf_counter() - t0
            la = sc.flatten((a.params, a.opt_state))
            lcc = sc.flatten((c.params, c.opt_state))
            differ = sum(not torch.equal(x, y) for x, y in zip(la, lcc))
            check(len(la) == len(lcc) and differ == 0,
                  f"{differ} of {len(la)} leaves differ after the restart")
            # the catalog against a dict model of saves and retention
            model = {}
            for s in range(lc.ckpt_every, DRILL_STEPS + 1, lc.ckpt_every):
                model[s] = True
                model = dict(sorted(model.items())[-2:])
            floors = {q: a.ckpt.latest_step(q) for q in range(26)}
            want = {q: max((s for s in model if s <= q), default=None)
                    for q in range(26)}
            check(a.ckpt.all_steps() == sorted(model) and floors == want
                  and a.ckpt.latest_step() == max(model),
                  f"catalog {a.ckpt.all_steps()} {floors}, model {want}")
            (p, st), manifest = a.ckpt.restore(DRILL_STEPS, (a.params,
                                                             a.opt_state))
            saved = sc.flatten((p, st))
            bf16 = [x for x in saved if x.dtype == torch.bfloat16]
            check(all(torch.equal(x, y) for x, y in zip(la, saved))
                  and len(bf16) > 0
                  and all(x.device == la[0].device for x in saved),
                  "a restored leaf differs from the saved one")
            launches = dict(build.LAUNCHES)
    finally:
        torch.use_deterministic_algorithms(False)
        if env_was is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_was
    print(f"  restart drill: {DRILL_STEPS} steps straight vs "
          f"{DRILL_STEPS // 2} + restore + {DRILL_STEPS // 2}, {len(la)} "
          f"leaves equal bit for bit (deterministic algorithms), "
          f"{drill_s:.3f} s for the three loops; losses "
          f"{[round(m['loss'], 4) for m in a.metrics_log]}; catalog "
          f"{a.ckpt.all_steps()}, latest_step(15) = {floors[15]}; the "
          f"step-{DRILL_STEPS} checkpoint ({manifest['n_leaves']} leaves, "
          f"{len(bf16)} bf16) restored onto the card bit for bit; "
          f"launches in the drill {launches}")
    check(not any(launches.values()), f"the restart drill launched a "
          f"kernel of the port: {launches}")
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, str(root / "examples" / "torch_train_lm.py")],
        capture_output=True, text=True, timeout=600, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    lines = run.stdout.strip().splitlines()
    for line in lines:
        print(f"  example: {line}")
    check(run.returncode == 0 and any("(LEARNING)" in x for x in lines),
          f"examples/torch_train_lm.py exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    print(f"  example: {time.perf_counter() - t0:.3f} s as a subprocess")
    return launches


if __name__ == "__main__":
    sys.exit(main())
