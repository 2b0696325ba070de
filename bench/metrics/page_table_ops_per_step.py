"""Host operations on the page table a decode step in the window: the
PUTs, GETs and DELETEs its calls count in their spans' tags (the device
GET batch of a lookup is not among them), over the window's
``engine.decode`` spans."""
from bench import spans


def read(run):
    w = spans.window(run)
    steps = spans.decode_steps(w) if w else 0
    if not steps:
        return None
    ops = sum(s.tags.get(k, 0) for s in spans.page_table_calls(w)
              for k in ("puts", "gets", "deletes"))
    return ops / steps
