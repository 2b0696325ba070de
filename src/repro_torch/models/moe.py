"""Mixture-of-Experts FFN (port of ``repro.models.moe``) for mixtral,
olmoe and jamba.

Three interchangeable implementations with the same math:

  * ``moe_dense``  — every expert computes every token, and the outputs
    are weighted by the top-k router probabilities (E/k more products
    than a token needs).  ``forward``, ``prefill`` and ``decode_step``
    use it by default, as the reference's do.
  * ``moe_ragged`` — tokens sorted by expert (a stable sort, as jnp's),
    then one product per contiguous expert group over the routed rows
    only.  The reference computes these with ``jax.lax.ragged_dot``
    outside any Pallas kernel; the port loops over the groups with
    ``torch.matmul``.
  * ``moe_grouped`` — forward only, for prefill: the same stable sort,
    made on the device, then grouped products over the routed rows and
    a combine in f32 in slot order (``kernels/ops.moe_grouped``: the
    hand-written kernels of ``kernels/moe_grouped.py`` on CUDA, their
    plain version on the CPU), rounding as ``moe_dense`` does and reading
    nothing back to the host.  The serving engine's prefill asks for it;
    decode stays dense, since a decode batch of 32 rows touches nearly
    every expert and routing would read the same weight bytes.

In bf16 dense and ragged round at other steps and may route a near-tied
token differently, so each is held to the reference's same
implementation; grouped rounds as dense does.

Router: softmax over the expert logits in f32, top-k, renormalised (the
mixtral formulation; olmoe normalises the same way).

Both train: ``moe_ragged``'s gradients are autograd's through its
slices, held to the reference's ragged gradients
(tests/test_torch_lm_loss.py).

Two mesh variants run under ``compat.shard_map`` with the reference's
specs, each over ``_ragged_ffn`` (a ``torch.autograd.Function``: three
grouped products over contiguous expert groups forward, every backward
term ragged as the reference's custom VJP keeps it):

  * ``moe_ep_ragged`` — experts sharded on the model axis; each rank
    sorts its tokens by local expert, computes at most ``cap`` routed rows
    (tokens past capacity dropped) and one ``psum`` over the expert axis
    combines each token's top-k outputs.
  * ``moe_fsliced_ragged`` — every model rank computes its d_ff slice of
    all routed rows (no capacity, no drops), combined in the model dtype
    and summed by one ``psum`` over the f axis.

Each returns the DTensor ``shard_map`` makes (batch on ``dp_axes``); the
reference's ``jax.lax.ragged_dot`` is no Pallas kernel, and each group's
product here is a ``torch.matmul``, the group sizes read back once a
call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..compat import PartitionSpec as P, axis_index, mesh_sizes, psum, \
    shard_map
from ..kernels import ops as kops
from ..kernels.ref import ragged_dot, routed_ffn
from .config import ArchConfig
from .schema import ParamDef

F32 = torch.float32


def moe_schema(cfg: ArchConfig):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": ParamDef((d, E), ("embed", None), F32),
        "w_gate": ParamDef((E, d, f), ("expert", "embed", "moe_mlp")),
        "w_up": ParamDef((E, d, f), ("expert", "embed", "moe_mlp")),
        "w_down": ParamDef((E, f, d), ("expert", "moe_mlp", "embed")),
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
    _, yy = routed_ffn(xs, p["w_gate"], p["w_up"], p["w_down"],
                       _group_sizes(eid, E))

    inv = torch.argsort(order)
    y = yy[inv] * gates[:, None].to(yy.dtype)
    return y.reshape(B, S, k, d).sum(dim=2).to(x.dtype)


def _group_sizes(eid, n_groups: int) -> list[int]:
    """The rows of each of ``n_groups`` groups of expert ids ``eid``, read
    back to the host (one sync).  A fake tensor (the dry run's,
    ``launch/dryrun.py``) holds no ids, so its rows are taken as split
    evenly over the groups: that moves no ragged product's FLOPs (2 * rows
    * p * q over all groups together), only the bytes of weights a real
    split would leave unread."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(eid):
        n = eid.shape[0]
        return [n // n_groups + (g < n % n_groups) for g in range(n_groups)]
    return torch.bincount(eid, minlength=n_groups).tolist()


# --- ragged FFN with exact ragged gradients ---------------------------------
def _ragged_outer(a, b, sizes):
    """[m, p], [m, q], groups over m -> [E, p, q]: per group a_gᵀ · b_g."""
    out = a.new_zeros(len(sizes), a.shape[1], b.shape[1])
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            out[e] = torch.matmul(a[lo:lo + n].T, b[lo:lo + n])
        lo += n
    return out


class _RaggedFFN(torch.autograd.Function):
    """silu(xs·wg) * (xs·wu) · wd per contiguous expert group.  The
    backward keeps every term ragged (the reference's ``_ragged_ffn_bwd``):
    dX through the transposed weights per group, dW as per-group outer
    products, from the saved ``gg``, ``uu`` and ``hh``."""

    @staticmethod
    def forward(ctx, xs, wg, wu, wd, sizes):
        gg = ragged_dot(xs, wg, sizes)
        uu = ragged_dot(xs, wu, sizes)
        hh = F.silu(gg) * uu
        ctx.save_for_backward(xs, wg, wu, wd, gg, uu, hh)
        ctx.sizes = sizes
        return ragged_dot(hh, wd, sizes)

    @staticmethod
    def backward(ctx, dy):
        xs, wg, wu, wd, gg, uu, hh = ctx.saved_tensors
        gs = ctx.sizes
        dhh = ragged_dot(dy, wd.transpose(1, 2), gs)
        dwd = _ragged_outer(hh, dy, gs)
        sig = torch.sigmoid(gg)
        dsilu = sig * (1 + gg * (1 - sig))
        dgg = dhh * uu * dsilu
        duu = dhh * F.silu(gg)
        dxs = ragged_dot(dgg, wg.transpose(1, 2), gs) \
            + ragged_dot(duu, wu.transpose(1, 2), gs)
        dwg = _ragged_outer(xs, dgg, gs)
        dwu = _ragged_outer(xs, duu, gs)
        return dxs, dwg, dwu, dwd, None


def _ragged_ffn(xs, wg, wu, wd, group_sizes):
    """The grouped FFN over rows sorted by expert; ``group_sizes`` [E]
    (a tensor, read back here once, or a list)."""
    sizes = group_sizes.tolist() if torch.is_tensor(group_sizes) \
        else list(group_sizes)
    return _RaggedFFN.apply(xs, wg, wu, wd, sizes)


def _route(xt, router, k: int):
    """top-k routing of rows [T, d] -> (gates [T*k] f32, experts [T*k])."""
    probs = torch.softmax(torch.matmul(xt.to(F32), router), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    return top_p.reshape(-1), top_i.reshape(-1)


def _dp_size(mesh, dp_axes) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in dp_axes:
        n *= sizes[a]
    return n


def moe_ep_ragged(p, x, cfg: ArchConfig, *, mesh, dp_axes,
                  expert_axis: str = "model"):
    """Expert-parallel ragged MoE under ``shard_map``.  Experts shard on
    ``expert_axis`` (replicated across data); each rank sorts ITS tokens by
    local expert, computes a capacity-bounded ragged product over routed
    rows only (cap = T_loc*k*E_loc/E * capacity_factor + 1 rows) and one
    ``psum`` over the expert axis combines each token's top-k partial
    outputs.  Rows beyond capacity are dropped; the invalid rows taken
    within it fold into the last group with zero gates."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // mesh_sizes(mesh)[expert_axis]
    T_loc = (B // _dp_size(mesh, dp_axes)) * S
    cap = int(T_loc * k * E_loc / E * cfg.capacity_factor) + 1

    def body(x_loc, router, wg, wu, wd):
        Bl, S_, d_ = x_loc.shape
        T = Bl * S_
        xt = x_loc.reshape(T, d_)
        gates, eid = _route(xt, router, k)
        eloc = eid - axis_index(mesh, expert_axis) * E_loc
        valid = (eloc >= 0) & (eloc < E_loc)
        # sort: local experts ascending, non-local last; take cap rows
        order = torch.argsort(torch.where(valid, eloc, E_loc), stable=True)
        sel = order[:cap]
        sel_valid = valid[sel]
        es = torch.where(sel_valid, eloc[sel], E_loc - 1)
        group_sizes = _group_sizes(es, E_loc)
        tok = sel // k                       # owning token of each row
        xs = xt[tok]                         # only the capacity rows
        gs = torch.where(sel_valid, gates[sel], 0.0)

        yy = _ragged_ffn(xs, wg, wu, wd, group_sizes)
        yy = yy.to(F32) * gs[:, None]
        # combine: scatter-add into [T, d] (duplicate tokens sum)
        out = torch.zeros((T, d_), dtype=F32, device=xt.device) \
            .index_add(0, tok, yy)
        out = psum(out, mesh, expert_axis)
        return out.reshape(Bl, S_, d_).to(x_loc.dtype)

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(dp_axes, None, None), P(None, None),
                  P(expert_axis, None, None), P(expert_axis, None, None),
                  P(expert_axis, None, None)),
        out_specs=P(dp_axes, None, None),
        check_vma=False,
    )(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])


def moe_fsliced_ragged(p, x, cfg: ArchConfig, *, mesh, dp_axes,
                       f_axis: str = "model"):
    """f-sliced ragged MoE: every rank of ``f_axis`` computes its d_ff
    slice of ALL routed rows (T*k exactly: no capacity, no drops); three
    ragged products over the local slice, the combine in the model dtype,
    one ``psum`` over the f axis completes the down-projection."""
    k = cfg.top_k
    E = cfg.n_experts

    def body(x_loc, router, wg, wu, wd):
        Bl, S_, d_ = x_loc.shape
        T = Bl * S_
        xt = x_loc.reshape(T, d_)
        gates, eid = _route(xt, router, k)
        order = torch.argsort(eid, stable=True)      # every row computed
        tok = order // k
        xs = xt[tok]
        group_sizes = _group_sizes(eid, E)

        yy = _ragged_ffn(xs, wg, wu, wd, group_sizes)  # f-slice partials
        # combine in the model dtype (halves the [T*k, d] buffers and the
        # psum's bytes, as in the reference)
        yy = yy * gates[order][:, None].to(yy.dtype)
        out = torch.zeros((T, d_), dtype=yy.dtype, device=xt.device) \
            .index_add(0, tok, yy)
        out = psum(out, mesh, f_axis)                # complete d_ff sums
        return out.reshape(Bl, S_, d_).to(x_loc.dtype)

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(dp_axes, None, None), P(None, None),
                  P(None, None, f_axis), P(None, None, f_axis),
                  P(None, f_axis, None)),
        out_specs=P(dp_axes, None, None),
        check_vma=False,
    )(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])


def moe_grouped(p, x, cfg: ArchConfig):
    """Each token through its top-k experts only, with no host read-back:
    ``kernels/ops.moe_grouped`` over ``router_probs``' routes.  Forward
    only (no autograd); rounds as ``moe_dense`` does.  x: [B, S, d]."""
    B, S, d = x.shape
    top_p, top_i = router_probs(p, x, cfg)
    out = kops.moe_grouped(x.reshape(B * S, d).contiguous(),
                           top_p.reshape(B * S, -1).contiguous(),
                           top_i.reshape(B * S, -1).contiguous(),
                           p["w_gate"], p["w_up"], p["w_down"])
    return out.reshape(B, S, d)


def moe(p, x, cfg: ArchConfig, impl="dense"):
    if callable(impl):
        return impl(p, x, cfg)
    if impl == "ragged":
        return moe_ragged(p, x, cfg)
    if impl == "grouped":
        return moe_grouped(p, x, cfg)
    return moe_dense(p, x, cfg)


def moe_flops_per_token(cfg: ArchConfig, active_only: bool = True) -> int:
    """2*d*f*3 matmuls, per selected expert."""
    e = cfg.top_k if active_only else cfg.n_experts
    return 6 * cfg.d_model * cfg.d_ff * e
