"""The whole serving loop's share of the card's dense bf16 peak in the
window: useful FLOPs of every prompt prefilled and every token decoded
there (``bench/counts.py`` with the configuration's reference module:
active parameters only, the routed experts and not all that the dense
MoE computes; causal attention over the live lengths), over the window's
seconds times 989 TFLOP/s, in percent."""
from bench import counts


def read(run):
    flops = sum(counts.prefill_flops(run.ref, run.arch, n)
                for s in run.steps for n, _ in s.prefills)
    flops += sum(counts.decode_flops(run.ref, run.arch, s.decoded, s.keys)
                 for s in run.steps if s.decoded)
    return 100.0 * flops / ((run.t1 - run.t0) * counts.PEAK_BF16_FLOPS)
