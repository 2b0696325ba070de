"""Deterministic, shard-aware, resumable token pipeline (port of
``repro.data.pipeline``, numpy and a thread as there; the batches are
bit-equal to the reference's for every (step, shard, n_shards)).

Every (data_shard, step) pair maps to a unique deterministic sample, so
  * restarts resume mid-epoch exactly (step index is the only state),
  * elastic re-sharding (a different number of data shards) replays the
    same global batch order,
  * no shard ever reads another shard's bytes.

Two sources: a seeded synthetic stream (benchmarks, smoke tests) and a
memory-mapped token file.  A background prefetch thread keeps ``depth``
batches ready, so a slow source shows up as queue starvation (counted)
rather than as a stalled step.  Batches are numpy arrays on the host;
the train step moves them to the card.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class TokenSource:
    def batch(self, step: int, shard: int, n_shards: int,
              batch_size: int, seq_len: int) -> dict[str, np.ndarray]:
        raise NotImplementedError


class SyntheticSource(TokenSource):
    """Seeded synthetic tokens, unique per (step, shard).

    Sequences follow a noisy affine recurrence (next = a*cur + c mod V with
    10% noise) so the stream is learnable: a training loop's loss falls."""

    def __init__(self, vocab: int, seed: int = 0, noise: float = 0.1):
        self.vocab = vocab
        self.seed = seed
        self.noise = noise

    def batch(self, step, shard, n_shards, batch_size, seq_len):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_size)
        a, c = 31, 17
        for t in range(seq_len):
            nxt = (toks[:, t] * a + c) % self.vocab
            noise = rng.random(batch_size) < self.noise
            toks[:, t + 1] = np.where(
                noise, rng.integers(0, self.vocab, batch_size), nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FileSource(TokenSource):
    """Flat int32 token file, memory-mapped; sequential epochs with a
    deterministic per-(step, shard) window."""

    def __init__(self, path: str):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def batch(self, step, shard, n_shards, batch_size, seq_len):
        n = len(self.tokens)
        span = batch_size * (seq_len + 1)
        stride = span * n_shards
        start = (step * stride + shard * span) % max(n - span, 1)
        window = np.asarray(self.tokens[start: start + span])
        window = window.reshape(batch_size, seq_len + 1)
        return {"tokens": window[:, :-1], "labels": window[:, 1:]}


class DataPipeline:
    def __init__(self, source: TokenSource, *, global_batch: int,
                 seq_len: int, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0, depth: int = 2):
        if global_batch % n_shards:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"into {n_shards} shards")
        self.source = source
        self.global_batch = global_batch
        self.local_batch = global_batch // n_shards
        self.seq_len = seq_len
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step
        self.depth = depth
        self.starvations = 0
        self._start()

    def _start(self):
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self.step
        while not self._stop.is_set():
            b = self.source.batch(step, self.shard, self.n_shards,
                                  self.local_batch, self.seq_len)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        if self._q.empty():
            self.starvations += 1
        step, b = self._q.get()
        self.step = step + 1
        return b

    def __iter__(self):
        return self

    def seek(self, step: int):
        """Deterministic resume: restart the prefetch thread at ``step``
        (checkpoint restore / elastic reconfiguration)."""
        self.close()
        self.step = step
        self._start()

    def close(self):
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        self._thread.join()

    def state(self) -> dict:
        return {"step": self.step, "shard": self.shard,
                "n_shards": self.n_shards}
