"""Plain reference of the served models, in PyTorch alone.

It imports nothing of the system under test.  It follows the
configuration file's ``arch`` block: decoder layers of kind ``G``
(causal GQA attention with RoPE) or ``M`` (a Mamba2 mixer: causal
depthwise conv, the selective state space recurrence with a scalar decay
a head, a gate and a grouped norm over the whole inner width), each
followed by a gated MLP or a top-k MoE FFN (every ``moe_every``-th
layer), RMSNorms before the mixer, the FFN and the head.

``layout`` names the weights as the benchmark draws them: a nested dict
whose ``blocks`` leaves carry a leading dimension over the periods of
the layer pattern.  The same tensors are handed to the program, so the
layout is also the program's parameter tree.

``logits_at`` runs whole sequences (prompt and served tokens, no paging
and no cache) and returns the logits at the positions asked for.  It
keeps only one layer's weights in the compute precision at a time, so a
model whose weights fill the card in bf16 still fits.  Precision
``"f32"`` is the reference: float32 throughout with TF32 off.
Precision ``"fp8"`` is the control: every product of a weight rounds
both operands to float8 e4m3 (a scale per row of the activations and
per output column of the weight) and accumulates in float32, the step
below the bf16 the configurations state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0          # largest finite float8 e4m3fn
EPS = 1e-6               # every RMSNorm
Q_BLOCK = 1024           # attention queries a block
SSD_CHUNK = 128          # positions a block of the state space scan


# ------------------------------------------------------------- structure
def layer_kinds(arch: dict) -> list[tuple[str, str | None]]:
    """[(mixer, ffn)] for one period of the pattern."""
    out = []
    every = arch.get("moe_every", 1)
    for i, kind in enumerate(arch["pattern"]):
        if arch["d_ff"] == 0:
            ffn = None
        elif arch.get("n_experts", 0) and (every == 1
                                           or i % every == every - 1):
            ffn = "moe"
        else:
            ffn = "mlp"
        out.append((kind, ffn))
    return out


def n_periods(arch: dict) -> int:
    if arch["n_layers"] % len(arch["pattern"]):
        raise ValueError("the pattern must divide n_layers")
    return arch["n_layers"] // len(arch["pattern"])


def ssm_dims(arch: dict) -> tuple[int, int, int, int]:
    """(inner width, heads, head size, state size) of a Mamba layer."""
    din = arch.get("ssm_expand", 2) * arch["d_model"]
    p = arch.get("ssm_head_dim", 64)
    return din, din // p, p, arch["ssm_state"]


# (shape, dtype, init); init is "normal" (std 1/sqrt(fan in), the fan
# in being the second-to-last dimension), "zeros" or "ones"
def layout(arch: dict) -> dict:
    d, v, f = arch["d_model"], arch["vocab"], arch["d_ff"]
    h, kv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    bf, n = torch.bfloat16, n_periods(arch)

    def norm(width):
        return {"scale": ((width,), F32, "ones")}

    def layer(kind, ffn):
        s = {"ln1": norm(d)}
        if kind == "M":
            din, nh, _, ns = ssm_dims(arch)
            conv = din + 2 * ns
            s["mamba"] = {
                "in_proj": ((d, 2 * din + 2 * ns + nh), bf, "normal"),
                "conv_w": ((arch.get("conv_width", 4), conv), bf, "normal"),
                "conv_b": ((conv,), F32, "zeros"),
                "A_log": ((nh,), F32, "zeros"),
                "D": ((nh,), F32, "ones"),
                "dt_bias": ((nh,), F32, "zeros"),
                "out_norm": ((din,), F32, "ones"),
                "out_proj": ((din, d), bf, "normal"),
            }
        else:
            s["attn"] = {"wq": ((d, h * hd), bf, "normal"),
                         "wk": ((d, kv * hd), bf, "normal"),
                         "wv": ((d, kv * hd), bf, "normal"),
                         "wo": ((h * hd, d), bf, "normal")}
        if ffn is not None:
            s["ln2"] = norm(d)
            if ffn == "moe":
                e = arch["n_experts"]
                s["ffn"] = {"router": ((d, e), F32, "normal"),
                            "w_gate": ((e, d, f), bf, "normal"),
                            "w_up": ((e, d, f), bf, "normal"),
                            "w_down": ((e, f, d), bf, "normal")}
            else:
                s["ffn"] = {"w_gate": ((d, f), bf, "normal"),
                            "w_up": ((d, f), bf, "normal"),
                            "w_down": ((f, d), bf, "normal")}
        return s

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(t) for k, t in tree.items()}
        shape, dtype, init = tree
        return ((n, *shape), dtype, init)

    return {
        "embed": ((v, d), bf, "normal"),
        "blocks": stacked({f"l{i}": layer(k, ffn)
                           for i, (k, ffn) in enumerate(layer_kinds(arch))}),
        "final_norm": norm(d),
        "lm_head": ((d, v), bf, "normal"),
    }


# ------------------------------------------------------------ precision
def _fp8(t, dim):
    """``t`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to the format's)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


class _Mm:
    """Weight products in the reference's precision."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.fp8 = precision == "fp8"

    def weight(self, w):
        """A weight [..., in, out] in the compute precision (an expert
        stack one expert at a time, to bound the temporaries)."""
        if not self.fp8:
            return w.to(F32)
        if w.dim() == 3:
            return torch.stack([_fp8(e.to(F32), -2) for e in w])
        return _fp8(w.to(F32), -2)

    def __call__(self, x, w):
        """x [..., in] @ w [in, out] (w from ``weight``)."""
        return torch.matmul(_fp8(x, -1) if self.fp8 else x, w)


# ---------------------------------------------------------------- layers
def rmsnorm(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def rope(x, theta):
    """x [T, heads, hd] at positions 0 .. T-1 (halves rotated)."""
    T, _, hd = x.shape
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * freq
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, arch, mm):
    T = x.shape[0]
    h, kv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    g = h // kv
    q = rope(mm(x, p["wq"]).reshape(T, h, hd), arch.get("rope_theta", 1e4))
    k = rope(mm(x, p["wk"]).reshape(T, kv, hd), arch.get("rope_theta", 1e4))
    v = mm(x, p["wv"]).reshape(T, kv, hd)
    qg = q.reshape(T, kv, g, hd).permute(1, 2, 0, 3)      # [kv, g, T, hd]
    kt = k.permute(1, 2, 0)[:, None]                      # [kv, 1, hd, T]
    vt = v.permute(1, 0, 2)[:, None]                      # [kv, 1, T, hd]
    out = torch.empty(kv, g, T, hd, dtype=F32, device=x.device)
    pos = torch.arange(T, device=x.device)
    for lo in range(0, T, Q_BLOCK):
        hi = min(lo + Q_BLOCK, T)
        s = torch.matmul(qg[:, :, lo:hi], kt[..., :hi]) / math.sqrt(hd)
        s = s.masked_fill(pos[None, :hi] > pos[lo:hi, None], float("-inf"))
        out[:, :, lo:hi] = torch.matmul(torch.softmax(s, -1), vt[..., :hi, :])
    o = out.permute(2, 0, 1, 3).reshape(T, h * hd)
    return mm(o, p["wo"])


def ssd_scan(x, dt, A, Bm, Cm, chunk=SSD_CHUNK):
    """The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, in blocks of ``chunk`` positions: inside a block in
    closed form, the state carried from block to block.
    x [T, H, P], dt [T, H], A [H], Bm/Cm [T, N] -> y [T, H, P]."""
    T, H, P = x.shape
    h = torch.zeros(H, P, Bm.shape[-1], dtype=F32, device=x.device)
    ys = []
    for lo in range(0, T, chunk):
        xs, ds = x[lo:lo + chunk], dt[lo:lo + chunk]
        bs, cs = Bm[lo:lo + chunk], Cm[lo:lo + chunk]
        q = xs.shape[0]
        a = torch.cumsum(ds * A, dim=0)                        # [q, H]
        later = torch.ones(q, q, dtype=torch.bool,
                           device=x.device).tril().logical_not()
        seg = (a[:, None, :] - a[None, :, :]).masked_fill(
            later[:, :, None], float("-inf"))                  # [t, s, H]
        w = (cs @ bs.T)[:, :, None] * seg.exp() * ds[None, :, :]
        y = torch.einsum("tsh,shp->thp", w, xs)
        y = y + a.exp()[:, :, None] * torch.einsum("tn,hpn->thp", cs, h)
        tail = (a[-1][None, :] - a).exp() * ds                  # [q, H]
        h = a[-1].exp()[:, None, None] * h \
            + torch.einsum("sh,shp,sn->hpn", tail, xs, bs)
        ys.append(y)
    return torch.cat(ys)


def mamba(p, x, arch, mm):
    T = x.shape[0]
    din, nh, hp, ns = ssm_dims(arch)
    zxbcdt = mm(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * ns, nh], dim=-1)
    W = p["conv_w"].shape[0]
    xp = torch.cat([xbc.new_zeros(W - 1, xbc.shape[1]), xbc])
    conv = sum(xp[i:i + T] * p["conv_w"][i] for i in range(W)) + p["conv_b"]
    xin, Bm, Cm = torch.split(F.silu(conv), [din, ns, ns], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(T, nh, hp)
    y = ssd_scan(xh, dt, A, Bm, Cm) + xh * p["D"][None, :, None]
    y = rmsnorm(y.reshape(T, din) * F.silu(z), p["out_norm"])
    return mm(y, p["out_proj"])


def mlp(p, x, mm):
    return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])


def moe(p, x, arch, mm):
    """Top-k experts a token, router softmax in f32, the k probabilities
    renormalised; only the chosen experts compute."""
    probs = torch.softmax(x @ p["router"], dim=-1)
    top_p, top_i = torch.topk(probs, arch["top_k"], dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(arch["n_experts"]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel():
            xe = x[rows]
            ye = mm(F.silu(mm(xe, p["w_gate"][e])) * mm(xe, p["w_up"][e]),
                    p["w_down"][e])
            out.index_add_(0, rows, ye * top_p[rows, slot][:, None])
    return out


# --------------------------------------------------------------- forward
def _period_weights(params, i, j, mm):
    """Layer ``j`` of period ``i``: every leaf in the compute precision
    (weights of products through ``mm.weight``, the rest in f32)."""
    prod = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
            "out_proj"}

    def conv(name, t):
        if isinstance(t, dict):
            return {k: conv(k, u) for k, u in t.items()}
        return mm.weight(t[i]) if name in prod else t[i].to(F32)
    return conv("", params["blocks"][f"l{j}"])


@torch.no_grad()
def logits_at(params, arch: dict, seqs, positions, precision="f32"):
    """Logits [len(positions[r]), V] (f32) of each sequence ``seqs[r]``
    (int tensors of token ids on the weights' device) at
    ``positions[r]``, each row the next-token logits after that
    position."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mm = _Mm(precision)
        xs = [params["embed"][s.long()].to(F32) for s in seqs]
        kinds = layer_kinds(arch)
        for i in range(n_periods(arch)):
            for j, (kind, ffn) in enumerate(kinds):
                p = _period_weights(params, i, j, mm)
                for r, x in enumerate(xs):
                    hn = rmsnorm(x, p["ln1"]["scale"])
                    x = x + (mamba(p["mamba"], hn, arch, mm) if kind == "M"
                             else attention(p["attn"], hn, arch, mm))
                    if ffn is not None:
                        hn = rmsnorm(x, p["ln2"]["scale"])
                        x = x + (moe(p["ffn"], hn, arch, mm) if ffn == "moe"
                                 else mlp(p["ffn"], hn, mm))
                    xs[r] = x
                del p
        head = mm.weight(params["lm_head"])
        scale = params["final_norm"]["scale"].to(F32)
        return [mm(rmsnorm(x[torch.as_tensor(pos, device=x.device).long()],
                           scale), head) for x, pos in zip(xs, positions)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
