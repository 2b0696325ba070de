"""Mixture-of-Experts FFN (port of ``repro.models.moe``) for mixtral,
olmoe and jamba.

Two interchangeable implementations with the same math:

  * ``moe_dense``  — every expert computes every token, and the outputs
    are weighted by the top-k router probabilities (E/k more products
    than a token needs).  ``forward``, ``prefill`` and ``decode_step``
    use it by default, as the reference's do.
  * ``moe_ragged`` — tokens sorted by expert (a stable sort, as jnp's),
    then one product per contiguous expert group over the routed rows
    only.  The reference computes these with ``jax.lax.ragged_dot``
    outside any Pallas kernel; the port loops over the groups with
    ``torch.matmul``.

In bf16 the two round at other steps and may route a near-tied token
differently, so each is held to the reference's same implementation.

Router: softmax over the expert logits in f32, top-k, renormalised (the
mixtral formulation; olmoe normalises the same way).

Both train: ``moe_ragged``'s gradients are autograd's through its
slices, held to the reference's ragged gradients
(tests/test_torch_lm_loss.py).

Not ported: ``moe_ep_ragged``/``moe_fsliced_ragged`` (``shard_map`` over
a device mesh) and ``_ragged_ffn`` with its custom VJP, whose only
callers they are (ROADMAP A, item 6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .schema import ParamDef

F32 = torch.float32


def moe_schema(cfg: ArchConfig):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": ParamDef((d, E), F32),
        "w_gate": ParamDef((E, d, f)),
        "w_up": ParamDef((E, d, f)),
        "w_down": ParamDef((E, f, d)),
    }


def router_probs(p, x, cfg: ArchConfig):
    """top-k routing -> (weights [B, S, k] f32, indices [B, S, k] int64)."""
    logits = torch.matmul(x.to(F32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i


def moe_dense(p, x, cfg: ArchConfig):
    """All-experts compute, router-weighted combine.  x: [B, S, d]."""
    B, S, d = x.shape
    top_p, top_i = router_probs(p, x, cfg)
    # [1, T, d] @ [E, d, f] -> [E, T, f]: one product batched over the
    # experts, each expert's weight read where it lies (an einsum
    # "bsd,edf->besf" shares no batch dimension and copies the whole
    # weight into [d, E*f] for a single mm, every call)
    xt = x.reshape(1, B * S, d)
    g = torch.matmul(xt, p["w_gate"])
    u = torch.matmul(xt, p["w_up"])
    y = torch.matmul(F.silu(g) * u, p["w_down"])             # [E, T, d]
    # each token's weight per expert: its top-k probabilities, 0 elsewhere
    w = torch.zeros(B * S, cfg.n_experts, dtype=F32, device=x.device) \
        .scatter_add_(-1, top_i.reshape(B * S, -1),
                      top_p.reshape(B * S, -1))
    out = torch.einsum("etd,te->td", y.to(F32), w)
    return out.reshape(B, S, d).to(x.dtype)


def moe_ragged(p, x, cfg: ArchConfig):
    """Sorted dispatch + one product per expert group: FLOP-exact top-k
    MoE.  Reads the group sizes back to the host (one sync a call)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    top_p, top_i = router_probs(p, x, cfg)
    xt = x.reshape(B * S, d).repeat_interleave(k, dim=0)     # [T, d]
    eid = top_i.reshape(-1)                                  # [T]
    gates = top_p.reshape(-1)

    order = torch.argsort(eid, stable=True)
    xs = xt[order]
    sizes = torch.bincount(eid, minlength=E).tolist()
    yy = torch.empty_like(xs)
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            rows = xs[lo:lo + n]
            h = F.silu(torch.matmul(rows, p["w_gate"][e])) \
                * torch.matmul(rows, p["w_up"][e])
            yy[lo:lo + n] = torch.matmul(h, p["w_down"][e])
        lo += n

    inv = torch.argsort(order)
    y = yy[inv] * gates[:, None].to(yy.dtype)
    return y.reshape(B, S, k, d).sum(dim=2).to(x.dtype)


def moe(p, x, cfg: ArchConfig, impl="dense"):
    if callable(impl):
        return impl(p, x, cfg)
    if impl == "ragged":
        return moe_ragged(p, x, cfg)
    return moe_dense(p, x, cfg)


def moe_flops_per_token(cfg: ArchConfig, active_only: bool = True) -> int:
    """2*d*f*3 matmuls, per selected expert."""
    e = cfg.top_k if active_only else cfg.n_experts
    return 6 * cfg.d_model * cfg.d_ff * e
