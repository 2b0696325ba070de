"""Paged attention's share of its roofline in the traced tail: the bytes
its launches must move (every visible K/V position of every row, each
row's query and output, in bf16) at 3.35 TB/s, over the device time of
its split and combining kernels, in percent."""
from bench import counts


def read(run):
    if run.trace is None:
        return None
    us = sum(t for name, (_, t) in run.trace.kernels.items()
             if "paged_attention_kernel" in name)
    steps = [s for s in run.trace_steps if s.decoded]
    if not us or not steps:
        return None
    # an idle row attends to one position of the scratch page
    nbytes = counts.attention_layers(run.ref, run.arch) * sum(
        counts.paged_attention_bytes(
            run.arch, s.keys + run.slots - s.decoded, run.slots)
        for s in steps)
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES / (us * 1e-6)
