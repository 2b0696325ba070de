"""AdamW with gradient clipping and an optional gradient-transform hook
(port of ``repro.train.optimizer``; the compression hook lives in
``distributed/compression.py``).

The reference builds new f32 ``grads``, ``mu``, ``nu`` and parameter
trees each step; at 3.4 B parameters those transients alone would take
about 41 GB beside the state.  ``update`` here works in place, leaf by
leaf: the moments and the parameters are updated where they lie, and f32
gradients are scaled where they lie, so the transients are a few tensors
of the largest leaf.  The arithmetic is the reference's, op for op, in
f32: the clip before the hook, the bias-corrected moments, weight decay
on every leaf, the update cast back to the parameter's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..models import schema as sc

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates taken
    mu: Any                 # f32 first moments, the parameters' tree
    nu: Any                 # f32 second moments


def init(params) -> OptState:
    """Zero moments in f32 beside each parameter (laid out as it is: a
    DTensor's moments are DTensors of its placements), step 0."""
    device = sc.flatten(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=sc.map_tree(lambda p: torch.zeros_like(p, dtype=F32), params),
        nu=sc.map_tree(lambda p: torch.zeros_like(p, dtype=F32), params))


def abstract_state(abstract_params) -> OptState:
    """The state's specs for a tree of parameter specs (no allocation)."""
    def f32(p):
        return sc.Spec(tuple(p.shape), F32)
    return OptState(step=sc.Spec((), torch.int32),
                    mu=sc.map_tree(f32, abstract_params),
                    nu=sc.map_tree(f32, abstract_params))


def _schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine decay to 0 at ``total_steps``; ``step``
    an f32 tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * cosine


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf in f32, summed leaf by
    leaf in the reference's leaf order (``schema.flatten``)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in sc.flatten(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params,
           grad_transform: Callable | None = None, gnorm=None):
    """One AdamW step.  ``grad_transform`` is the compression hook, given
    the clipped f32 gradients (after clipping, as in the reference).
    ``gnorm`` is the gradients' global norm where the caller took it: the
    trees a mesh's train step passes hold one rank's shards, whose norm
    is not the whole tree's (``launch/steps.build_step``).

    In place: the parameters, ``state.mu`` and ``state.nu`` are updated
    where they lie, and ``grads``' f32 leaves are scaled where they lie
    (the caller hands them over).  Returns (params, OptState with the new
    step, gnorm), the trees being the ones passed in."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    grads = sc.map_tree(
        lambda g: g.mul_(scale) if g.dtype == F32 else g.to(F32) * scale,
        grads)
    if grad_transform is not None:
        grads = grad_transform(grads)

    step = state.step + 1
    t = step.to(F32)
    lr = _schedule(cfg, t)
    b1c = 1 - torch.pow(cfg.b1, t)
    b2c = 1 - torch.pow(cfg.b2, t)

    def leaf(p, g, m, v):
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.to(F32)
        u = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        u.add_(cfg.weight_decay * pf)
        p.copy_(pf - lr * u)
    sc.map_tree(leaf, params, grads, state.mu, state.nu)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), gnorm
