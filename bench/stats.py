"""The window's arithmetic: which deliveries, first tokens and gaps fall
in a measured window, and percentiles over all of their samples."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Record:
    """What the client of one request saw: when it submitted, and each
    ``step()`` return that delivered tokens (time, how many)."""
    k: int                       # index in the traffic stream
    prompt_len: int
    max_new: int
    submit_t: float
    deliveries: list = dataclasses.field(default_factory=list)
    done_t: float | None = None
    tokens: list | None = None   # the served tokens, once finished
    seen: int = 0                # tokens delivered so far
    prompt: object = None        # the prompt's token ids


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, interpolated linearly
    between the order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    at = (len(xs) - 1) * q / 100.0
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def in_window(t: float, t0: float, t1: float) -> bool:
    """A step return at ``t`` is in the window (t0, t1]: after the window
    opened and no later than the last step it holds."""
    return t0 < t <= t1


@dataclasses.dataclass
class Window:
    prompt_tokens: int
    generated: int
    ttft_s: list
    itl_s: list
    finished: list


def window(records, t0: float, t1: float) -> Window:
    """Tokens, first-token times and gaps of the window (t0, t1]:
    prompt tokens of every request whose first token arrived in it,
    every token delivered in it, the time from submit to the first
    token's delivery, and every gap between two deliveries to one request
    that both lie in it (tokens a step delivers together make one
    delivery)."""
    prompt = gen = 0
    ttft, itl, finished = [], [], []
    for r in records:
        if not r.deliveries:
            continue
        first_t = r.deliveries[0][0]
        if in_window(first_t, t0, t1):
            prompt += r.prompt_len
            ttft.append(first_t - r.submit_t)
        gen += sum(n for t, n in r.deliveries if in_window(t, t0, t1))
        times = [t for t, _ in r.deliveries]
        itl += [b - a for a, b in zip(times, times[1:])
                if in_window(a, t0, t1) and in_window(b, t0, t1)]
        if r.done_t is not None and in_window(r.done_t, t0, t1):
            finished.append(r)
    return Window(prompt, gen, ttft, itl, finished)

