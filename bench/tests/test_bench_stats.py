"""The window's arithmetic on synthetic timestamps."""
import numpy as np
import pytest

from bench import harness, stats


def rec(k, submit, deliveries, done=None, prompt=100, tokens=None):
    r = stats.Record(k, prompt, 4, submit, list(deliveries), done)
    r.tokens = tokens
    return r


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        x = rng.exponential(size=n)
        for q in (0, 50, 95, 99, 100):
            assert stats.percentile(x, q) == pytest.approx(
                np.percentile(x, q), rel=1e-12)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_p95_over_all_samples_not_chunks():
    """The tail of one slow burst is the tail of all samples; a mean of
    per-chunk p95s would dilute it."""
    fast = [0.1] * 190
    slow = [1.0] * 10
    chunks = [fast[:100], fast[100:] + slow]
    over_chunks = np.mean([stats.percentile(c, 95) for c in chunks])
    whole = stats.percentile(fast + slow, 95)
    assert whole == pytest.approx(np.percentile(fast + slow, 95))
    assert whole == pytest.approx(0.1 + 0.9 * 0.05)
    assert over_chunks == pytest.approx(0.55)


def test_window_edges():
    t0, t1 = 10.0, 20.0
    rs = [
        # first token before the window: no TTFT, its later tokens count
        rec(0, 8.0, [(9.0, 2), (11.0, 1), (12.0, 1)], 12.0,
            tokens=[1, 2, 3, 4]),
        # submitted before, first token in it: TTFT 3 s, prompt counted
        rec(1, 9.0, [(12.0, 2), (13.0, 1)], 13.0, prompt=500,
            tokens=[1, 2, 3]),
        # a delivery exactly at t0 is outside, at t1 inside
        rec(2, 9.5, [(10.0, 2), (20.0, 1)], 20.0, prompt=300,
            tokens=[1, 2, 3]),
        # first token after the window: nothing counts
        rec(3, 19.0, [(20.5, 2)], None, prompt=700),
    ]
    w = stats.window(rs, t0, t1)
    assert w.prompt_tokens == 500
    assert w.generated == (1 + 1) + (2 + 1) + 1
    assert w.ttft_s == [3.0]
    # gaps with both ends in (t0, t1]: 11->12, 12->13; not 9->11, 10->20
    assert sorted(w.itl_s) == [1.0, 1.0]
    assert [r.k for r in w.finished] == [0, 1, 2]


def test_end_to_end():
    rs = [rec(k, 0.5, [(1.0 + k, 2), (1.5 + k, 1)], 1.5 + k, prompt=10)
          for k in range(4)]
    run = harness.Run({}, 1, 0.9, 4.9, rs, [])
    e = harness.end_to_end(run, 12.5)
    assert e["tokens_per_s"] == pytest.approx((40 + 12) / 4.0)
    assert e["setup_s"] == 12.5
    assert e["itl_p95_ms"] == pytest.approx(500.0)


def test_expected_tokens():
    assert harness.expected_tokens(100, 16, 4096) == 16
    assert harness.expected_tokens(100, 1, 4096) == 2
    assert harness.expected_tokens(1024, 512, 1536) == 512
    assert harness.expected_tokens(1030, 512, 1536) == 506
