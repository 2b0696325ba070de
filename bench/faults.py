"""Faults planted underneath the timed path, one for each way a served
cell's step can go wrong on one chip (there is no exchange between chips
to leave out), and a wrong page from the page table.  Each is a context
manager: inside it, the program's ``transformer.decode_step`` (or the
page table's block-table lookup) is replaced by a broken one.  The CPU tests
and ``bench.calibrate --fault`` (on the card, at a cell's own size) run
the closed loop inside one and see the check come out not correct."""
from __future__ import annotations

import contextlib


def _wrap(broken):
    @contextlib.contextmanager
    def planted():
        from repro_torch.models import transformer as tf
        inner = tf.decode_step
        tf.decode_step = broken(inner)
        try:
            yield
        finally:
            tf.decode_step = inner
    planted.__doc__ = broken.__doc__
    return planted


@_wrap
def state_unchanged(inner):
    """A decode step that leaves its state as it found it: it runs on
    copies of every cache leaf (K/V pages, Mamba state), so nothing it
    writes outlives it."""
    def step(params, cfg, cache, tokens, *a, **kw):
        layers = {name: {kind: t.clone() for kind, t in leaves.items()}
                  for name, leaves in cache.layers.items()}
        return inner(params, cfg, cache._replace(layers=layers), tokens,
                     *a, **kw)
    return step


@_wrap
def half_batch(inner):
    """Half of the decode batch left out: its rows' logits are never
    computed (zeros)."""
    def step(params, cfg, cache, tokens, *a, **kw):
        logits, c = inner(params, cfg, cache, tokens, *a, **kw)
        logits[logits.shape[0] // 2:] = 0
        return logits, c
    return step


@_wrap
def token_altered(inner):
    """Every fourth decode step serves each row its runner-up token."""
    calls = []

    def step(params, cfg, cache, tokens, *a, **kw):
        import torch
        logits, c = inner(params, cfg, cache, tokens, *a, **kw)
        calls.append(1)
        if len(calls) % 4 == 0:
            rows = torch.arange(logits.shape[0], device=logits.device)
            logits[rows, logits.argmax(-1)] = -1e30
        return logits, c
    return step


@contextlib.contextmanager
def wrong_page():
    """The decode step's block tables each name another request's first
    page in place of their own (the rows' first pages rotated)."""
    import numpy as np
    from repro_torch.serving import kv_cache
    inner = kv_cache.PagedKVCache.lookup_block_tables

    def lookup(self, seq_ids, n_blocks):
        rows = inner(self, seq_ids, n_blocks).copy()
        rows[:, 0] = np.roll(rows[:, 0], 1)
        return rows
    kv_cache.PagedKVCache.lookup_block_tables = lookup
    try:
        yield
    finally:
        kv_cache.PagedKVCache.lookup_block_tables = inner


ALL = {"state_unchanged": state_unchanged, "half_batch": half_batch,
       "token_altered": token_altered, "wrong_page": wrong_page}
