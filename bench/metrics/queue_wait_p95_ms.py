"""The 95th percentile, in milliseconds, of how long a request waited
from ``submit`` to the start of its prefill, over the requests whose
prefill started in the window: the program's ``request.queue`` spans.
This is the part of the time to first token spent behind the other
prefills of a tick and behind full slots."""
from bench import spans, stats


def read(run):
    w = spans.window(run)
    q = [s.t1 - s.t0 for s in w or () if s.name == "request.queue"]
    return stats.percentile(q, 95) * 1e3 if q else None
