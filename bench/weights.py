"""The served weights, drawn on the card from the run's seed.

Every leaf of the reference's ``layout`` is a view into one buffer per
dtype; each buffer is filled by one call of a ``torch.Generator`` on the
device, in the type the leaf is served in.  A ``normal`` leaf is then
scaled to std 1/sqrt(fan in) in place, ``ones`` and ``zeros`` leaves are
filled.  The program and the reference read these same tensors.
"""
from __future__ import annotations

import math

import torch

ALIGN = 128          # elements: every leaf starts on a 256-byte boundary


def leaves(tree, path=()):
    """(path, leaf) of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, t in tree.items():
            yield from leaves(t, path + (k,))
    else:
        yield path, tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw(layout: dict, seed: int, device) -> dict:
    """The weights of ``layout`` (nested dict of (shape, dtype, init)) as
    a nested dict of tensors on ``device``, the same for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    flat = list(leaves(layout))
    offsets, totals = [], {}
    for _, (shape, dtype, _) in flat:
        at = totals.get(dtype, 0)
        offsets.append(at)
        totals[dtype] = at + -(-math.prod(shape) // ALIGN) * ALIGN
    bufs = {}
    for dtype, n in totals.items():
        bufs[dtype] = torch.empty(n, dtype=dtype, device=device)
        bufs[dtype].normal_(generator=gen)
    out: dict = {}
    for (path, (shape, dtype, init)), at in zip(flat, offsets):
        t = bufs[dtype][at:at + math.prod(shape)].view(shape)
        if init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t.mul_(1.0 / math.sqrt(max(fan_in, 1)))
        _put(out, path, t)
    return out

