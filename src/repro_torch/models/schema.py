"""Parameter schema (port of ``repro.models.schema``): one source of truth
for shapes, dtypes and initializers.

A model declares its parameters once as a nested dict of ``ParamDef``;
``init`` draws real parameters from it with an explicit
``torch.Generator``, and ``from_numpy`` carries the reference's parameters
(a nested dict of numpy arrays) into the port leaf for leaf.  The
reference's logical sharding axes and mesh specs are not ported: the port
runs on one card.

Trees are nested dicts of leaves; the training state adds tuples (the
optimizer's ``OptState``).  ``flatten``/``unflatten`` walk them in
``jax.tree.flatten``'s order (dict keys sorted), which the reference's
checkpoints and its gradient norm follow.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones | embed


@dataclasses.dataclass(frozen=True)
class Spec:
    """An array's shape and dtype (the reference's ShapeDtypeStruct); a
    leaf of a tree, not a tuple."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def stack(n: int, tree):
    """Prepend a stacked-layers dimension to every ParamDef in a tree."""
    return map_tree(lambda d: ParamDef((n, *d.shape), d.dtype, d.init), tree)


def map_tree(fn, tree, *rest):
    """Apply ``fn`` to the leaves of nested dicts, keeping the structure;
    with more trees of the same structure, ``fn`` takes their leaves too."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten(tree) -> list:
    """The leaves in ``jax.tree.flatten``'s order: dict keys sorted,
    tuples (named or not) and lists in order, None holding no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flatten(v)]
    return [] if tree is None else [tree]


def unflatten(like, leaves):
    """``leaves`` (in ``flatten``'s order) in the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*map(build, t))
        if isinstance(t, (tuple, list)):
            return type(t)(map(build, t))
        return None if t is None else next(it)
    try:
        out = build(like)
    except StopIteration:
        raise ValueError("fewer leaves than the structure holds") from None
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def n_params(tree) -> int:
    return sum(math.prod(d.shape) for d in flatten(tree))


def init(tree, generator: torch.Generator, device):
    """Real parameters on ``device``: ``zeros``/``ones`` as named, every
    other leaf normal / sqrt(fan_in) (fan_in = the second-to-last dim),
    drawn in f32 from ``generator`` leaf by leaf, then cast.  (The
    reference draws from ``jax.random``: the two give other numbers from
    one seed.)"""
    if isinstance(tree, dict):
        return {k: init(v, generator, device) for k, v in tree.items()}
    d = tree
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(d.dtype)


def from_numpy(tree, device="cpu"):
    """The reference's parameters (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as tensors on ``device``, names
    unchanged, each a copy.  bfloat16 arrays (numpy's ``ml_dtypes``
    extension type, which ``torch.from_numpy`` refuses) cross as their
    16-bit patterns."""
    def conv(a):
        a = np.require(a, requirements=["C", "W"])   # torch wants writable
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device, copy=True)
    return map_tree(conv, tree)
