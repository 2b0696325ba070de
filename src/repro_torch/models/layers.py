"""Transformer layers (port of ``repro.models.layers``): RMSNorm, RoPE,
GQA attention for prefill (causal, sliding window, ``seq_lens`` mask,
query chunks) and for paged decode, the gated MLP, and the
encoder-decoder cross attention (no RoPE, no causal mask), which the
encoder also runs as its bidirectional self-attention.

Pure functions of (params, inputs, cfg) with the reference's dtypes step
by step: scores, softmax, RoPE and norms in f32, probabilities cast to
V's type before the product, results cast back to the input's type.  The
large products stay ``torch.matmul``, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ArchConfig
from .schema import ParamDef

F32 = torch.float32
NEG_INF = -2.3819763e38


# ----------------------------------------------------------------- norms
def rmsnorm_schema(d: int):
    return {"scale": ParamDef((d,), (None,), F32, "ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------ rope
def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    angles = positions[..., None].to(F32) * freq           # [..., S, half]
    angles = angles[..., None, :]                          # [..., S, 1, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention
def attention_schema(cfg: ArchConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamDef((d, h * hd), ("embed", "heads")),
        "wk": ParamDef((d, kv * hd), ("embed", "kv")),
        "wv": ParamDef((d, kv * hd), ("embed", "kv")),
        "wo": ParamDef((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((h * hd,), ("heads",), F32, "zeros")
        s["bk"] = ParamDef((kv * hd,), ("kv",), F32, "zeros")
        s["bv"] = ParamDef((kv * hd,), ("kv",), F32, "zeros")
    return s


def _qkv(p, x, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = rope(q.reshape(B, S, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, kv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, kv, hd)


def _softcap(s, cap: float):
    return torch.tanh(s / cap) * cap if cap else s


def attention(p, x, cfg: ArchConfig, *, local: bool, positions=None,
              seq_lens=None, q_chunk: int = 4096):
    """Causal self-attention for prefill.  ``local`` selects the
    sliding-window mask (cfg.window); ``seq_lens`` [B] masks keys at or
    past each sequence's length.

    KV heads are repeated to the query head count before the score
    product.  Sequences longer than ``q_chunk`` take their queries in
    blocks of ``q_chunk`` (the live score buffer is [B, H, q_chunk, S]);
    as in the reference, such a length must be a multiple of ``q_chunk``.
    Returns (out [B, S, d], (k, v)) with k after RoPE."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    g, hd = cfg.q_per_kv, cfg.head_dim
    kr = torch.repeat_interleave(k, g, dim=2)      # [B, S, H, hd]
    vr = torch.repeat_interleave(v, g, dim=2)
    krf = kr.to(F32)
    scale = hd ** -0.5

    def block(q_blk, pos_blk):
        """q_blk: [B, Q, H, hd]; pos_blk: [B, Q] -> [B, Q, H, hd]."""
        s = torch.einsum("bqhd,bshd->bhqs", q_blk.to(F32) * scale, krf)
        s = _softcap(s, cfg.attn_softcap)
        qp = pos_blk[:, None, :, None]
        kp = positions[:, None, None, :]
        mask = kp <= qp
        if local and cfg.window:
            mask &= kp > qp - cfg.window
        if seq_lens is not None:
            mask &= kp < seq_lens[:, None, None, None]
        s = torch.where(mask, s, NEG_INF)
        probs = torch.softmax(s, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", probs.to(vr.dtype), vr)

    if S <= q_chunk:
        o = block(q, positions)
    else:
        nq = S // q_chunk
        qs = q.reshape(B, nq, q_chunk, cfg.n_heads, hd)
        ps = positions.reshape(B, nq, q_chunk)
        o = torch.cat([block(qs[:, i], ps[:, i]) for i in range(nq)], dim=1)
    o = o.reshape(B, S, cfg.n_heads * hd)
    return torch.matmul(o, p["wo"]), (k, v)


def decode_attention(p, x, cfg: ArchConfig, k_pages, v_pages, block_tables,
                     seq_lens, *, local: bool, page_size: int, attn=None,
                     local_impl=None):
    """Single-token decode over a paged KV cache (scatter, then attend).

    x: [B, 1, d]; k_pages/v_pages: [NP, P, KVH, HD] (this layer's pool);
    block_tables: [B, PPS] int32 physical page ids (Honeycomb page-table
    lookups); seq_lens: [B] int32 tokens already in the cache (the new
    token's position).  ``attn`` is the paged attention
    (``kernels/ops.paged_attention`` when None: the hand-written kernel on
    CUDA, its plain version on the CPU).  ``local_impl`` (the mesh's
    ``distributed/paged_attention.paged_attention_local`` with its layout
    bound) replaces both the scatter and the attention:
    ``local_impl(q, k_pages, v_pages, block_tables, seq_lens, start, k_new,
    v_new, scale=, softcap=) -> (out, k_pages, v_pages)``.

    The new token's K/V is written into its page slot IN PLACE on the
    pools, where the reference's ``.at[].set`` makes new arrays; then one
    paged attention pass covers history and self.  Returns
    (out [B, 1, d], (k_pages, v_pages)), the pools being the ones passed
    in."""
    attn = attn or kops.paged_attention
    B = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, seq_lens[:, None])
    q = q[:, 0].contiguous()                         # [B, H, HD]
    k_new, v_new = k[:, 0], v[:, 0]                  # [B, KVH, HD]

    new_lens = seq_lens + 1
    if local and cfg.window:
        start = torch.clamp(new_lens - cfg.window, min=0)
    else:
        start = torch.zeros_like(new_lens)

    if local_impl is not None:
        o, k_pages, v_pages = local_impl(
            q, k_pages, v_pages, block_tables, seq_lens, start, k_new,
            v_new, scale=hd ** -0.5, softcap=cfg.attn_softcap)
    else:
        rows = torch.arange(B, device=x.device)
        pos = seq_lens.long()
        page = block_tables[rows, pos // page_size].long()
        slot = pos % page_size
        k_pages[page, slot] = k_new.to(k_pages.dtype)
        v_pages[page, slot] = v_new.to(v_pages.dtype)
        o = attn(q, k_pages, v_pages, block_tables, new_lens, start,
                 scale=hd ** -0.5, softcap=cfg.attn_softcap)
    o = o.reshape(B, 1, h * hd).to(x.dtype)
    return torch.matmul(o, p["wo"]), (k_pages, v_pages)


# ------------------------------------------------------------------- mlp
def mlp_schema(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "mlp")),
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed")),
    }


def mlp(p, x):
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(F.silu(g) * u, p["w_down"])


# ------------------------------------------------------- cross attention
def cross_attention_schema(cfg: ArchConfig):
    return attention_schema(cfg)


def cross_attention(p, x, ctx, cfg: ArchConfig, ctx_lens=None):
    """Encoder-decoder cross attention: queries from x [B, S, d], keys
    and values from the encoder output ctx [B, Senc, d].  No RoPE and no
    causal mask (as in the reference, the projections' biases are not
    added); ``ctx_lens`` [B] masks keys at or past each row's length."""
    B, S, _ = x.shape
    Senc = ctx.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, S, h, hd)
    k = torch.matmul(ctx, p["wk"]).reshape(B, Senc, kv, hd)
    v = torch.matmul(ctx, p["wv"]).reshape(B, Senc, kv, hd)
    g = cfg.q_per_kv
    kr = torch.repeat_interleave(k, g, dim=2)      # [B, Senc, H, hd]
    vr = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.to(F32) * hd ** -0.5, kr.to(F32))
    if ctx_lens is not None:
        mask = torch.arange(Senc, device=x.device)[None, :] \
            < ctx_lens[:, None]
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bshd->bqhd", probs.to(vr.dtype), vr)
    return torch.matmul(o.reshape(B, S, h * hd), p["wo"])
