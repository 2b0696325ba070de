"""Milliseconds of host time the page table takes a decode step in the
window: the program's spans of the table's calls (a prefill's page PUTs,
each decode step's page check, its block-table lookup with the delta sync
and the GET's result copies, the frees of finished requests), summed,
over the window's ``engine.decode`` spans."""
from bench import spans


def read(run):
    w = spans.window(run)
    steps = spans.decode_steps(w) if w else 0
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in spans.page_table_calls(w)) * 1e3 / steps
