"""Percent of the traced tail's window in which no device activity ran
(the profiler's trace, opened and closed on idle guards)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
