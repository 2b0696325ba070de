"""Microseconds of device time the page table costs a decode step, in the
traced tail: every device activity launched from inside the page table's
calls (the block-table GET with its delta sync, page allocation and
freeing: the fused GET and row-scatter kernels and their copies), over
the tail's decode steps."""


def read(run):
    steps = sum(1 for s in run.trace_steps if s.decoded)
    if run.trace is None or not steps:
        return None
    us = sum(t for name, t in run.trace.range_device_us.items()
             if name.startswith("page_table."))
    return us / steps if us else None
