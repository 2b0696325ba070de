"""Mamba2 (SSD, state-space duality) blocks, arXiv:2405.21060 (port of
``repro.models.mamba2``).

Prefill uses the chunked SSD algorithm: the sequence is split into
chunks; within a chunk the output is the quadratic "attention-like" form,
across chunks a compact recurrent state [H, P, N] is carried (a Python
loop over chunks, where the reference runs ``lax.scan``).  The
three-operand contractions run pairwise, so no [B, nc, Q, Q, H, P]
tensor is built.  Decode is the pure recurrence: the state is what the
serving engine keeps at a request's slot row, the mamba layers' "page".

Jamba's mamba layers reuse this module with their own (state 16)
geometry.

Prefill of a padded prompt: ``mamba_block(..., last_pos=...)`` returns
the state after each row's last real token.  Positions past it get a
step of 0 (no decay, no input), and the conv tail is read at it.  The
reference's engine instead carries the state over the pad tail too, so
that a request whose prompt is not a multiple of the page size decodes
from a state the pad tokens changed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import rmsnorm, rmsnorm_schema
from .schema import ParamDef

F32 = torch.float32


class MambaState(NamedTuple):
    ssm: torch.Tensor     # [B, H, P, N] recurrent state
    conv: torch.Tensor    # [B, W-1, conv_dim] causal-conv tail


def mamba_schema(cfg: ArchConfig):
    d = cfg.d_model
    din = cfg.d_inner
    H = cfg.n_ssm_heads
    N = cfg.ssm_state
    G = 1  # B/C groups
    conv_dim = din + 2 * G * N
    # in_proj emits [z, x, B, C, dt]
    d_proj = 2 * din + 2 * G * N + H
    return {
        "in_proj": ParamDef((d, d_proj), ("embed", "mlp")),
        "conv_w": ParamDef((cfg.conv_width, conv_dim),
                           (None, "mlp")),
        "conv_b": ParamDef((conv_dim,), ("mlp",), F32, "zeros"),
        "A_log": ParamDef((H,), (None,), F32, "zeros"),
        "D": ParamDef((H,), (None,), F32, "ones"),
        "dt_bias": ParamDef((H,), (None,), F32, "zeros"),
        "out_norm": rmsnorm_schema(din)["scale"],
        "out_proj": ParamDef((din, d), ("mlp", "embed")),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    din, N = cfg.d_inner, cfg.ssm_state
    z, xbc, dt = torch.split(
        zxbcdt, [din, din + 2 * N, zxbcdt.shape[-1] - 2 * din - 2 * N],
        dim=-1)
    return z, xbc, dt


def _causal_conv(p, xbc, conv_tail=None, last_pos=None):
    """Depthwise causal conv, width W.  xbc: [B, S, C].  Returns the
    activations and the new tail, the W-1 inputs ending at the last
    position (at ``last_pos`` [B] when given), in ``xbc``'s dtype."""
    W = p["conv_w"].shape[0]
    B, S, C = xbc.shape
    if conv_tail is None:
        pad = torch.zeros(B, W - 1, C, dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                 # [B, S+W-1, C]
    out = sum(xp[:, i: i + S] * p["conv_w"][i].to(xbc.dtype)
              for i in range(W))
    out = out + p["conv_b"].to(xbc.dtype)
    if last_pos is None:
        new_tail = xp[:, S:]
    else:                       # xp rows last_pos+1 .. last_pos+W-1
        idx = last_pos.long()[:, None] + torch.arange(
            1, W, device=xbc.device)
        new_tail = xp[torch.arange(B, device=xbc.device)[:, None], idx]
    return F.silu(out), new_tail


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan (Mamba2 paper, Listing 1).

    xh: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    Bm/Cm: [B,S,N] (single group).  Returns y [B,S,H,P] (f32) and the
    final state [B,H,P,N] (f32).  ``chunk`` must divide S."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {chunk}")
    nc, Q = S // chunk, chunk

    dA = dt * A[None, None, :]                        # [B,S,H]
    xdt = xh * dt[..., None]                          # [B,S,H,P]

    def r(t):
        return t.reshape(Bsz, nc, Q, *t.shape[2:])
    dA_c, xdt_c = r(dA), r(xdt.to(F32))
    B_c, C_c = r(Bm).to(F32), r(Cm).to(F32)

    cs = torch.cumsum(dA_c, dim=2)                    # [B,nc,Q,H]
    # intra-chunk ("diagonal block"): L[i,j] = exp(cs_i - cs_j) for i >= j,
    # masked BEFORE the exp (above the diagonal cs_i - cs_j >= 0 overflows)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [B,nc,Q,Q,H]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    L = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                  float("-inf")))
    G = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", G[..., None] * L, xdt_c)

    # chunk state contributions: decay from position to chunk end
    decay_out = torch.exp(cs[:, :, -1:, :] - cs)      # [B,nc,Q,H]
    states = torch.einsum("bcqn,bcqhp->bchpn", B_c,
                          decay_out[..., None] * xdt_c)  # [B,nc,H,P,N]
    chunk_decay = torch.exp(cs[:, :, -1, :])          # [B,nc,H]

    # inter-chunk recurrence, keeping the state BEFORE each chunk
    h = torch.zeros(Bsz, H, P, N, dtype=F32, device=xh.device)
    before = []
    for c in range(nc):
        before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(before, dim=1)               # [B,nc,H,P,N]

    # inter-chunk ("off-diagonal"): contribution of the carried-in state
    decay_in = torch.exp(cs)                          # [B,nc,Q,H]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", C_c, h_prev) \
        * decay_in[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y, h


def mamba_block(p, x, cfg: ArchConfig, chunk: int = 64,
                return_state: bool = False, last_pos=None):
    """Full Mamba2 block for prefill.  x: [B,S,d] -> [B,S,d].

    With ``return_state`` also returns the MambaState after the last
    token, or after position ``last_pos`` [B] of each row (the prefill ->
    decode handoff of a padded prompt).  The chunk is min(chunk, S), and
    it must divide S."""
    B, S, _ = x.shape
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc_conv, conv_tail = _causal_conv(p, xbc, last_pos=last_pos)
    xin, Bm, Cm = torch.split(xbc_conv, [cfg.d_inner, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    if last_pos is not None:    # a step of 0 past the last real token
        keep = torch.arange(S, device=x.device)[None, :] \
            <= last_pos.long()[:, None]
        dt = dt * keep[..., None]
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, H, P)
    y, hT = _ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(chunk, S))
    y = y + xh.to(F32) * p["D"][None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": p["out_norm"]}, y)
    out = torch.matmul(y, p["out_proj"])
    if return_state:
        return out, MambaState(ssm=hT, conv=conv_tail)
    return out


def mamba_decode(p, x, state: MambaState, cfg: ArchConfig):
    """Single-token recurrence.  x: [B,1,d] -> ([B,1,d], new state)."""
    B = x.shape[0]
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, conv_tail = _causal_conv(p, xbc, state.conv)
    xin, Bm, Cm = torch.split(xbc, [cfg.d_inner, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])[:, 0]     # [B,H]
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, H, P).to(F32)
    dA = torch.exp(dt * A[None, :])                       # [B,H]
    dBx = (dt[:, :, None] * xh)[..., None] \
        * Bm[:, 0].to(F32)[:, None, None, :]              # [B,H,P,N]
    h = state.ssm * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(F32), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": p["out_norm"]}, y)
    out = torch.matmul(y, p["out_proj"])
    return out, MambaState(ssm=h, conv=conv_tail)


def init_state(cfg: ArchConfig, batch: int) -> MambaState:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return MambaState(
        ssm=torch.zeros(batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                        cfg.ssm_state, dtype=F32),
        conv=torch.zeros(batch, cfg.conv_width - 1, conv_dim, dtype=F32))
