"""The traffic generator: the same seed gives the same stream, every seed
the same sizes, in an order the seed draws."""
import collections

import numpy as np
import pytest

from bench import traffic

MIXES = ["docqa_s32_4k", "docqa_s16_4k", "chat_s32_1k5"]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_stream(mix):
    a = traffic.Traffic(traffic.load(mix), 2 ** 31 + 11, 50304)
    b = traffic.Traffic(traffic.load(mix), 2 ** 31 + 11, 50304)
    for k in (0, 1, a.slots - 1, a.slots, 200):
        pa, na = a.request(k)
        pb, nb = b.request(k)
        assert na == nb and np.array_equal(pa, pb)
        assert pa.dtype == np.int32 and 0 <= pa.min() and pa.max() < 50304
    c = traffic.Traffic(traffic.load(mix), 2 ** 31 + 12, 50304)
    assert not np.array_equal(a.request(5)[0], c.request(5)[0])


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_serves_the_deck(mix):
    """Each pass through the deck serves its sizes once, whatever the
    seed."""
    for seed in (0, -3, 2 ** 33 + 1):
        t = traffic.Traffic(traffic.load(mix), seed, 1000)
        for cycle in range(3):
            ks = range(cycle * t.deck, (cycle + 1) * t.deck)
            got = collections.Counter(t.sizes(k)[0] for k in ks)
            assert got == collections.Counter(t.prompt_lens)
            got = collections.Counter(t.sizes(k)[1] for k in ks)
            assert got == collections.Counter(t.new_lens)


def test_order_drawn_from_the_seed():
    """The run seed draws the order, each pass anew: two seeds, or two
    passes of one seed, serve the deck in other orders."""
    spec = traffic.load("docqa_s32_4k")
    a = traffic.Traffic(spec, 2 ** 31 + 5, 1000)
    b = traffic.Traffic(spec, 2 ** 31 + 6, 1000)
    n = a.deck
    order = [a.sizes(k) for k in range(2 * n)]
    assert order != [b.sizes(k) for k in range(2 * n)]
    assert order[:n] != order[n:]
    assert order == [traffic.Traffic(spec, 2 ** 31 + 5, 7).sizes(k)
                     for k in range(2 * n)]


def test_strata():
    d = {"dist": "lognormal", "median": 1536, "sigma": 0.5, "min": 512,
         "max": 3840}
    s = traffic.strata(d, 64)
    assert s == sorted(s) and s[0] >= 512 and s[-1] <= 3840
    assert s[31] <= 1536 <= s[32]
    u = traffic.strata({"dist": "uniform", "min": 16, "max": 64}, 49)
    assert u == list(range(16, 65))


def test_first_requests_answer_a_share():
    t = traffic.Traffic(traffic.load("docqa_s32_4k"), 9, 100)
    shares = [t.request(k)[1] / t.sizes(k)[1] for k in range(t.slots)]
    assert all(0 < s <= 1 for s in shares)
    assert len(set(round(s, 3) for s in shares)) > t.slots // 2
    assert t.request(t.slots)[1] == t.sizes(t.slots)[1]


def test_buckets_are_page_multiples():
    t = traffic.Traffic(traffic.load("docqa_s16_4k"), 1, 100)
    assert all(b % t.page == 0 for b in t.buckets())
    assert max(t.buckets()) == 4096
