"""``shard_map`` and the collectives its bodies use, over a
``torch.distributed`` ``DeviceMesh`` (port of ``repro.compat``, whose
``shard_map`` picks between JAX's two spellings of it).

One process per device: gloo on the CPU, NCCL on the card.  A mesh's
dimension names are the reference's axis names (``data``, ``model``,
``pod``, ``stage``), and a ``PartitionSpec`` names, per tensor dimension,
None, a mesh axis or a tuple of mesh axes (major to minor), with the
reference's meaning.

``shard_map(f, mesh=, in_specs=, out_specs=)`` returns a function of
global values: each argument is a DTensor on ``mesh`` or a plain tensor,
which stands for a value replicated on every rank.  The argument is
redistributed to its spec's placements and ``f`` runs on each rank's
local block; each output block becomes a DTensor with its out spec's
placements.  Gradients follow JAX's rule for ``check_vma=False`` (the
only mode the reference uses): an output's cotangent is divided by the
sizes of the mesh axes its spec leaves out, and an input's cotangent is
summed over the axes its spec leaves out (a ``Partial`` placement, which
DTensor reduces where the value came from).  ``psum``'s backward is a
``psum``, as JAX transposes it, so the two rules cancel for a body that
ends in a ``psum``.

What differs from JAX: the bodies run eagerly on each rank, so
``axis_index`` is a Python int and a mask that depends on it is a Python
branch; ``ppermute`` is a paired ``isend``/``irecv`` in one
``batch_isend_irecv`` (a self pair is a copy: neither backend sends to
itself).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: per tensor
    dimension None, a mesh axis name or a tuple of names; dimensions past
    its end are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` where tensor dimension d names it, else ``Replicate()``.

    DTensor splits a tensor dimension over several mesh dimensions in
    mesh order, the first one major; a tuple entry must list its axes in
    that order, which is JAX's major-to-minor order for the same tuple."""
    names = tuple(mesh.mesh_dim_names)
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _names(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: no mesh axis {a!r} in {names}")
            if a in dim_of:
                raise ValueError(f"{spec}: mesh axis {a!r} used twice")
            dim_of[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: {axes} is not in the mesh's order "
                             f"{names}")
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


def _check_divisible(shape, pl, mesh) -> None:
    split: dict[int, int] = {}
    for p, n in zip(pl, mesh.shape):
        if isinstance(p, Shard):
            split[p.dim] = split.get(p.dim, 1) * n
    for d, n in split.items():
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {n} shards")


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _enter(x, spec, mesh):
    """A global value's local block under ``spec``."""
    pl = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    _check_divisible(x.shape, pl, mesh)
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    grad_pl = [p if isinstance(p, Shard) else Partial() for p in pl]
    return x.to_local(grad_placements=grad_pl)


def _leave(y, spec, mesh):
    """A local block as the global DTensor ``spec`` lays out."""
    pl = placements(spec, mesh)
    left_out = math.prod(n for p, n in zip(pl, mesh.shape)
                         if not isinstance(p, Shard))
    if y.requires_grad and left_out > 1:
        y = _ScaleGrad.apply(y, 1.0 / left_out)
    return DTensor.from_local(y, mesh, list(pl), run_check=False)


def _map_spec(fn, tree, spec):
    """``fn(leaf, spec)`` over a tree of tensors (dicts, tuples, lists)
    whose structure ``spec`` follows or whose every leaf one spec
    covers."""
    if isinstance(spec, PartitionSpec):
        if isinstance(tree, dict):
            return {k: _map_spec(fn, v, spec) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(_map_spec(fn, v, spec) for v in tree)
        return fn(tree, spec)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, tree[k], spec[k]) for k in tree}
    if len(spec) != len(tree):
        raise ValueError(f"{len(tree)} values for {len(spec)} specs")
    return type(tree)(_map_spec(fn, t, s) for t, s in zip(tree, spec))


def shard_map(f, *, mesh, in_specs, out_specs, check_vma: bool = False):
    """``f`` mapped over ``mesh``'s blocks (see the module docstring).
    ``check_vma`` is accepted for the reference's signature; as there, its
    only value in use is False."""
    if check_vma:
        raise NotImplementedError("check_vma=True: the reference never "
                                  "asks for it")

    def mapped(*args):
        local = _map_spec(lambda x, s: _enter(x, s, mesh), args,
                          tuple(in_specs))
        return _map_spec(lambda y, s: _leave(y, s, mesh), f(*local),
                         out_specs)
    return mapped


def full_value(x):
    """A DTensor's full value on every rank (a one-rank mesh's block, with
    no collective); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.to_local() if x.device_mesh.size() == 1 else x.full_tensor()


# ------------------------------------------------------------ collectives
def axis_index(mesh, name: str) -> int:
    """This rank's index along mesh axis ``name``."""
    return mesh.get_local_rank(name)


def _all_reduce(x, group):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x, mesh, name):
    """The sum of ``x`` over mesh axis ``name`` (or a tuple of axes),
    differentiable: the backward is a ``psum`` of the cotangent."""
    for a in _names(name):
        x = _PSum.apply(x, mesh.get_group(a))
    return x


def _send_recv(x, mesh, name: str, perm) -> torch.Tensor:
    group = mesh.get_group(name)
    me = mesh.get_local_rank(name)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, perm):
        ctx.mesh, ctx.name = mesh, name
        ctx.inverse = tuple((d, s) for s, d in perm)
        return _send_recv(x, mesh, name, perm)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.mesh, ctx.name, ctx.inverse), None, None, \
            None


def ppermute(x, mesh, name: str, perm):
    """JAX's ``ppermute`` over mesh axis ``name``: for each (src, dst)
    pair of axis indices, src's ``x`` lands on dst; a rank no pair sends
    to gets zeros.  Differentiable (the backward permutes back)."""
    return _PPermute.apply(x, mesh, name, tuple(map(tuple, perm)))
