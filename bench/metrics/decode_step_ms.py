"""Milliseconds a decode step in the window: the engine's own
``decode_s`` (block-table lookup to sampled token on the host), summed
over the window's decode steps, over their count."""


def read(run):
    dec = [s.decode_s for s in run.steps if s.decode_s is not None]
    return sum(dec) * 1e3 / len(dec) if dec else None
