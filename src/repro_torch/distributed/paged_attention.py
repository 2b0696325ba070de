"""Distributed paged decode attention: ``shard_map``-local page pools (port
of ``repro.distributed.paged_attention``).

With pools sharded over (data x model) and block tables holding global
page ids, a global gather cannot see that a sequence's pages are local:
it gathers the pools and repeats the attention on the model axis.  Here
the pages live in the pool shard that owns the sequence, and the scatter
and the attention run inside a ``shard_map`` where every reference is
local:

  * batch and the pool's page dimension shard together on
    ``batch_axes``: a sequence's pages live with its rows, and block-table
    ids are rebased to local rows;
  * the model axis shards KV heads when divisible (q heads follow; no
    collective), else head_dim (one [B, KVH, G, S] scores ``psum`` a step);
  * the new token's K/V is written in place on the owning shard.

With KV heads split (or no model axis) the attention after the scatter is
``kernels/ops.paged_attention``: the hand-written ``csrc/paged_attention.cu``
on CUDA, its plain version on the CPU; both compute the reference body's
masked f32 softmax.  With head_dim split the scores are computed plainly,
``psum``-ed over that axis, then soft-capped, masked and soft-maxed as in
the reference.  The reference splits q into [B, KVH, G, D] before the map;
the port maps q as [B, H, D] (H = KVH * G, so a split of H on the model
axis is the same split of KVH) and regroups inside the body.
"""
from __future__ import annotations

import torch

from ..compat import PartitionSpec as P, axis_index, mesh_sizes, psum, \
    shard_map
from ..kernels import ops as kops

F32 = torch.float32
NEG_INF = -1e30


def paged_attention_local(q, k_pages, v_pages, block_tables, seq_lens,
                          start_pos, k_new, v_new, *, mesh, batch_axes,
                          kv_head_axis: str | None,
                          head_dim_axis: str | None, page_size: int,
                          scale: float, softcap: float = 0.0):
    """Locality-preserving paged decode attention + KV scatter.

    q:            [B, H, D]
    k/v_pages:    [NP, P, KVH, D] — NP sharded on ``batch_axes`` aligned
                  with B (sequence i's pages live in shard i's rows)
    block_tables: [B, PPS] GLOBAL page ids (engine layout: shard-contiguous)
    seq_lens:     [B] history length (the new token's position)
    k_new/v_new:  [B, KVH, D] this step's K/V (written locally)
    returns (out [B, H, D], k_pages, v_pages) as DTensors; the pools'
    local blocks are the ones passed in, written in place.  ``out`` is f32
    on the plain route, q's type from the kernel."""
    NP = k_pages.shape[0]
    sizes = mesh_sizes(mesh)
    n_data = 1
    for a in batch_axes:
        n_data *= sizes[a]
    np_local = NP // n_data

    kv_spec = P(batch_axes, None, kv_head_axis, head_dim_axis)
    q_spec = P(batch_axes, kv_head_axis, head_dim_axis)
    new_spec = P(batch_axes, kv_head_axis, head_dim_axis)

    def body(q, kp, vp, bt, lens, start, kn, vn):
        # rebase global page ids to this shard's local pool rows
        shard = 0
        for a in batch_axes:
            shard = shard * sizes[a] + axis_index(mesh, a)
        bt_loc = bt - shard * np_local
        rows = torch.arange(bt.shape[0], device=bt.device)
        pos = lens.long()
        page = bt_loc[rows, pos // page_size].long()
        slot = pos % page_size
        kp[page, slot] = kn.to(kp.dtype)
        vp[page, slot] = vn.to(vp.dtype)
        new_lens = lens + 1
        if head_dim_axis is None:
            o = kops.paged_attention(q.contiguous(), kp, vp, bt_loc,
                                     new_lens, start, scale=scale,
                                     softcap=softcap)
            return o, kp, vp
        b, h, d = q.shape
        kvh = kp.shape[2]
        qg = q.reshape(b, kvh, h // kvh, d)
        k = kp[bt_loc.long()].reshape(b, -1, kvh, d)
        v = vp[bt_loc.long()].reshape(b, -1, kvh, d)
        s = torch.einsum("bkgd,bskd->bkgs", qg.to(F32) * scale, k.to(F32))
        # the contraction dim was sharded: finish the dot before softmax
        s = psum(s, mesh, head_dim_axis)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        p_ = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (p_ < new_lens[:, None]) & (p_ >= start[:, None])
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        probs = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskd->bkgd", probs, v.to(F32))
        return o.reshape(b, h, d), kp, vp

    return shard_map(
        body, mesh=mesh,
        in_specs=(q_spec, kv_spec, kv_spec, P(batch_axes, None),
                  P(batch_axes), P(batch_axes), new_spec, new_spec),
        out_specs=(q_spec, kv_spec, kv_spec),
        check_vma=False,
    )(q, k_pages, v_pages, block_tables, seq_lens, start_pos, k_new, v_new)
