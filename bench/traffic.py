"""The one traffic generator: a closed loop of clients over a mix that a
data file in ``bench/traffic/<name>.json`` describes.

The file gives the slots (one client each), the sequence limit, the page
size, and the prompt and answer lengths as distributions (``lognormal``
by median and sigma, or ``uniform``), clipped to [min, max].  Lengths
come from a deck of ``deck`` strata of each distribution: every seed
serves the same sizes, and the run seed draws their order, a fresh
uniform permutation of the deck on each pass through it (prompt and
answer lengths permuted apart).  The run seed also draws the prompts'
token ids, uniform over the vocabulary (and the weights).  The k-th
request of the stream is the k-th submitted, whichever client sends it.

Each client's first request answers only part of its length (a share
the run seed draws): the clients start out of step, as a loop that has
run for a while would be.
"""
from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def strata(dist: dict, n: int) -> list[int]:
    """``n`` lengths at the midpoints of ``n`` equal strata of ``dist``."""
    lo, hi = dist["min"], dist["max"]
    qs = [(k + 0.5) / n for k in range(n)]
    if dist["dist"] == "uniform":
        return [lo + int(q * (hi - lo + 1)) for q in qs]
    if dist["dist"] == "lognormal":
        z = statistics.NormalDist()
        return [min(hi, max(lo, round(dist["median"] * float(
            np.exp(dist["sigma"] * z.inv_cdf(q)))))) for q in qs]
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *key])


class Traffic:
    """The request stream of one mix and one seed."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, seed, vocab
        self.slots = spec["slots"]
        self.max_seq = spec["max_seq"]
        self.page = spec["page_size"]
        self.deck = spec["deck"]
        self.prompt_lens = strata(spec["prompt"], self.deck)
        self.new_lens = strata(spec["new_tokens"], self.deck)
        if max(self.prompt_lens) + max(self.new_lens) > self.max_seq:
            raise ValueError("a prompt and its answer can outgrow max_seq")
        self._order: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def sizes(self, k: int) -> tuple[int, int]:
        """(prompt length, answer length) of the k-th request."""
        cycle, at = divmod(k, self.deck)
        if cycle not in self._order:
            rng = _rng(self.seed, 0, cycle)
            self._order[cycle] = (rng.permutation(self.deck),
                                  rng.permutation(self.deck))
        p, n = self._order[cycle]
        return self.prompt_lens[p[at]], self.new_lens[n[at]]

    def request(self, k: int) -> tuple[np.ndarray, int]:
        """(prompt token ids, max new tokens) of the k-th request; the
        first ``slots`` requests, one a client, answer a share of their
        length."""
        s, n = self.sizes(k)
        prompt = _rng(self.seed, 1, k).integers(
            0, self.vocab, s, dtype=np.int32)
        if k < self.slots:
            share = (_rng(self.seed, 2).permutation(self.slots)[k]
                     + 0.5) / self.slots
            n = max(1, round(share * n))
        return prompt, n

    def buckets(self) -> list[int]:
        """The padded prompt lengths the deck can prefill."""
        return sorted({-(-s // self.page) * self.page
                       for s in self.prompt_lens})

    def warm_prompt(self, length: int) -> np.ndarray:
        return _rng(self.seed, 3, length).integers(
            0, self.vocab, length, dtype=np.int32)
