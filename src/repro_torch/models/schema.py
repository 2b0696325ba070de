"""Parameter schema (port of ``repro.models.schema``): one source of truth
for shapes, dtypes, logical sharding axes and initializers.

A model declares its parameters once as a nested dict of ``ParamDef``;
``init`` draws real parameters from it with an explicit
``torch.Generator``, and ``from_numpy`` carries the reference's parameters
(a nested dict of numpy arrays) into the port leaf for leaf.  Each leaf
names its dimensions' logical axes, as in the reference; ``shardings``
maps them through a rule table (``distributed/sharding.make_rules``) onto
a ``DeviceMesh``'s dimensions and gives each leaf its DTensor placements
(the reference's ``NamedSharding``).  ``place`` lays a full tree out on a
mesh by those placements and ``gather`` brings it back whole.

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

from ..compat import PartitionSpec as P, full_value, placements


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names, len == ndim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones | embed

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in length")


@dataclasses.dataclass(frozen=True)
class Spec:
    """An array's shape and dtype (the reference's ShapeDtypeStruct); a
    leaf of a tree, not a tuple."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def stack(n: int, tree):
    """Prepend a stacked-layers dimension (logical axis ``"layers"``) to
    every ParamDef in a tree."""
    return map_tree(lambda d: ParamDef((n, *d.shape), ("layers", *d.axes),
                                       d.dtype, d.init), tree)


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


def logical_specs(tree):
    """A ``PartitionSpec`` of logical axis names per leaf."""
    return map_tree(lambda d: P(*d.axes), tree)


def to_mesh_specs(logical_tree, rules: dict):
    """Map logical axis names to mesh axis names through ``rules`` (a name
    the rules lack maps to None: replicated)."""
    return map_tree(lambda s: P(*(None if ax is None else rules.get(ax)
                                  for ax in s)), logical_tree)


def shardings(tree, rules: dict, mesh):
    """Each leaf's DTensor placements on ``mesh``: per mesh dimension,
    ``Shard(d)`` where tensor dimension d maps to it, else
    ``Replicate()``.  A leaf is a tuple: walk such a tree with
    ``map_tree`` (``flatten`` opens tuples)."""
    return map_tree(lambda s: placements(s, mesh),
                    to_mesh_specs(logical_specs(tree), rules))


def place(tree, placement_tree, mesh):
    """A tree of full tensors (equal on every rank) laid out on ``mesh`` as
    DTensors by ``placement_tree`` (``shardings``' output).  A leaf
    replicated on every mesh dimension may keep its tensor's storage: a
    step that updates the placed tree in place changes that tensor too."""
    from torch.distributed.tensor import distribute_tensor
    return map_tree(lambda t, pl: distribute_tensor(t, mesh, list(pl)),
                    tree, placement_tree)


def gather(tree):
    """Every DTensor leaf of a tree as its full tensor on every rank."""
    return map_tree(full_value, tree)


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
