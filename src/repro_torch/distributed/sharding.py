"""Sharding rules: logical axes -> mesh axes (port of
``repro.distributed.sharding``).

Mesh axes (``launch/mesh.py``): ``data`` (DP/FSDP), ``model`` (TP/EP) and
``pod`` (cross-pod DP) in the multi-pod mesh.  ``ShardingPolicy``, ``_div``
and ``make_rules`` are the reference's line for line: they read only the
mesh's axis names and sizes, so a stand-in with ``mesh_dim_names`` and
``shape`` serves as well as a ``DeviceMesh``.

Baseline layout: weights 2D-sharded ("embed" on data, FSDP-style;
"heads"/"kv"/"mlp"/"vocab"/"expert-inner" on model), activations batch on
(pod, data), MoE experts on model only under ``expert_parallel``, decode KV
pools' page dimension on (pod, data) and KV heads on model when divisible,
else head_dim; every mapping divisibility-checked, an indivisible axis
replicated.

Where the reference returns ``NamedSharding``s, the port returns DTensor
placements (a tuple per leaf, one entry per mesh dimension).  The
reference threads ``shard`` through its models to pin activation layouts
(``with_sharding_constraint``), which fixes layout and not values; the
port's models take no ``shard=``.  ``make_shard_fn`` and ``constrain``
redistribute a DTensor to the rules' placements and leave a plain tensor
as it is.
"""
from __future__ import annotations

import dataclasses

from ..compat import PartitionSpec as P, mesh_sizes, placements
from ..models import schema as sc
from ..models.config import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Tunable knobs."""
    expert_parallel: bool = False   # experts on model axis (needs E % model)
    fsdp_embed: bool = True         # "embed" on data axis
    seq_parallel_pages: bool = True  # KV pages on data axis
    decode_impl: str = "gather"     # "gather" (baseline) | "local"


def _div(n: int, size: int) -> bool:
    return n > 0 and n % size == 0


def make_rules(cfg: ArchConfig, mesh, shape: ShapeConfig | None = None,
               policy: ShardingPolicy = ShardingPolicy()) -> dict:
    axes = mesh_sizes(mesh)
    model = axes.get("model", 1)
    data = axes.get("data", 1)
    has_pod = "pod" in axes
    dp = ("pod", "data") if has_pod else ("data",)
    dp_size = axes.get("pod", 1) * data

    batch = shape.global_batch if shape else 0
    rules: dict[str, object] = {
        "layers": None,
        "vocab": "model" if _div(cfg.vocab, model) else None,
        "embed": ("data" if policy.fsdp_embed and _div(cfg.d_model, data)
                  else None),
        "heads": ("model"
                  if _div(cfg.n_heads * cfg.head_dim, model) else None),
        "kv": ("model"
               if _div(cfg.n_kv_heads * cfg.head_dim, model) else None),
        "mlp": "model" if _div(max(cfg.d_ff, cfg.d_inner), model) else None,
        "expert": ("model" if policy.expert_parallel
                   and _div(cfg.n_experts, model) else None),
        # the MoE inner dim: TP normally; unsharded under EP (axis is taken)
        "moe_mlp": (None if (policy.expert_parallel
                             and _div(cfg.n_experts, model))
                    else ("model" if _div(cfg.d_ff, model) else None)),
        # activations / caches
        "batch": dp if _div(batch, dp_size) else (
            "data" if _div(batch, data) else None),
        "kv_pages": dp if policy.seq_parallel_pages else None,
        "kv_heads": "model" if _div(cfg.n_kv_heads, model) else None,
        "head_dim": (None if _div(cfg.n_kv_heads, model)
                     else ("model" if _div(cfg.head_dim, model) else None)),
        # activation constraint axes
        "seq": None,
        # "heads_act" is used by attention ([B,S,H*hd]) and by mamba
        # ([B,S,H_ssm,P]); only shard when every user's dim divides
        "heads_act": ("model"
                      if ((not cfg.n_heads
                           or _div(cfg.n_heads * cfg.head_dim, model))
                          and (not cfg.ssm_state
                               or _div(cfg.n_ssm_heads, model))
                          and (cfg.n_heads or cfg.ssm_state))
                      else None),
        "kv_act": ("model"
                   if _div(cfg.n_kv_heads * cfg.head_dim, model) else None),
        "mlp_act": ("model"
                    if _div(max(cfg.d_ff, cfg.d_inner), model) else None),
        "vocab_act": "model" if _div(cfg.vocab, model) else None,
        "expert_act": ("model" if policy.expert_parallel
                       and _div(cfg.n_experts, model) else None),
    }
    return rules


def _spec(rules: dict, logical_axes) -> P:
    return P(*(rules.get(a) if a is not None else None
               for a in logical_axes))


def constrain(x, mesh, rules: dict, logical_axes: tuple):
    """A DTensor redistributed to the placements the rules give its
    logical axes; a plain tensor unchanged."""
    if not hasattr(x, "redistribute"):
        return x
    return x.redistribute(mesh, placements(_spec(rules, logical_axes),
                                           mesh))


def make_shard_fn(mesh, rules: dict):
    """``shard(x, logical_axes)``: ``constrain`` on ``mesh`` by ``rules``."""
    def shard(x, logical_axes):
        return constrain(x, mesh, rules, logical_axes)
    return shard


def param_shardings(cfg: ArchConfig, mesh, rules: dict):
    from ..models import transformer as tf
    return sc.shardings(tf.schema(cfg), rules, mesh)


def named(mesh, *axes) -> tuple:
    """The placements of ``P(*axes)`` on ``mesh``."""
    return placements(P(*axes), mesh)


def batch_shardings(cfg: ArchConfig, mesh, rules: dict, batch_tree) -> dict:
    """Every batch input sharded on its leading (batch) dimension."""
    b = rules.get("batch")
    return sc.map_tree(lambda x: named(mesh, b, *([None] * (len(x.shape)
                                                           - 1))),
                       batch_tree)
