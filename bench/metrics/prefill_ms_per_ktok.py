"""Prefill milliseconds per 1,000 prompt tokens in the window: the
engine's own ``prefill_s`` of each request it prefilled there (a host
clock that ends in a device sync), summed, over the prompt tokens."""


def read(run):
    pre = [p for s in run.steps for p in s.prefills]
    tokens = sum(n for n, _ in pre)
    return sum(sec for _, sec in pre) * 1e6 / tokens if tokens else None
