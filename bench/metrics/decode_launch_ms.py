"""Milliseconds the host takes to enqueue a decode step's forward in the
window: the mean of the program's ``model.decode`` spans, from the call
to its return, before the sampled tokens are waited for.  This is the
host work CUDA graphs would take off the step."""
from bench import spans


def read(run):
    w = spans.window(run)
    d = [s.t1 - s.t0 for s in w or () if s.name == "model.decode"]
    return sum(d) * 1e3 / len(d) if d else None
