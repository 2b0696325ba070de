"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis (port
of ``repro.distributed.pipeline``).

Stage s holds layers [s*L/S, (s+1)*L/S); microbatches stream through a
``ppermute`` ring, so at steady state every stage computes a different
microbatch (a fill/drain bubble of (S-1)/(M+S-1)).  ``shard_map`` and a
loop over the ticks, as the reference's ``lax.fori_loop``.  The reference
computes masked work on an idle stage (SPMD); here each rank knows its
stage index as a Python int, so an idle stage skips the call and keeps its
carry, which gives the same values.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..compat import PartitionSpec as P, axis_index, mesh_sizes, ppermute, \
    psum, shard_map
from ..models.schema import map_tree


def pipeline_apply(fn: Callable, stage_params, x_micro, *, mesh,
                   stage_axis: str):
    """Run ``fn(params_s, x)`` through S pipeline stages.

    fn:           shape-preserving stage function (e.g. a block of layers)
    stage_params: tree (nested dicts) of leaves with leading dim S, sharded
                  P(stage_axis): stage s's parameters live on stage s
    x_micro:      [M, mb, ...] microbatched input (replicated)
    returns       [M, mb, ...] outputs, a DTensor replicated on every rank
    """
    S = mesh_sizes(mesh)[stage_axis]
    M = x_micro.shape[0]
    T = M + S - 1
    perm = [(i, (i + 1) % S) for i in range(S)]

    def body(params_local, xs):
        p = map_tree(lambda a: a[0], params_local)
        sid = axis_index(mesh, stage_axis)
        cur = torch.zeros_like(xs[0])
        outs = [torch.zeros_like(xs[0]) for _ in range(M)]
        for t in range(T):
            # receive the previous stage's last output (ring permute)
            recv = ppermute(cur, mesh, stage_axis, perm)
            if t < sid or t - sid >= M:
                continue                     # idle: fill or drain
            cur = fn(p, xs[min(t, M - 1)] if sid == 0 else recv)
            if sid == S - 1:                 # the last stage emits t - sid
                outs[t - sid] = cur
        # only the last stage holds real outputs; replicate via psum
        return psum(torch.stack(outs), mesh, stage_axis)

    spec = map_tree(lambda _: P(stage_axis), stage_params)
    return shard_map(body, mesh=mesh, in_specs=(spec, P()), out_specs=P(),
                     check_vma=False)(stage_params, x_micro)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe fill/drain overhead: (S-1) / (M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
