"""The program's own spans in a run's window, for the readers in
``metrics/``: the ring ``repro_torch.core.telemetry.SPANS`` that the
serving engine and its page table record into, over the spans that end
in (``run.t0``, ``run.t1``].  The window is read, not the traced tail:
the tail runs under the profiler, which slows host code.  A program
without the ring, or a window from which the ring dropped spans, reads
None."""
from __future__ import annotations


def window(run) -> list | None:
    """The window's spans, oldest end first, or None."""
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    ring = getattr(telemetry, "SPANS", None)
    return None if ring is None else ring.window(run.t0, run.t1)


def page_table_calls(spans: list) -> list:
    """The page table's calls that no other call of it encloses: a page
    PUT of a prefill, a decode step's page check (with its PUTs), a
    lookup (with its sync and its GET batch), a free."""
    names = {s.tags["id"]: s.name for s in spans}
    return [s for s in spans if s.name.startswith("page_table.")
            and not names.get(s.tags["parent"], "").startswith(
                "page_table.")]


def decode_steps(spans: list) -> int:
    return sum(1 for s in spans if s.name == "engine.decode")
