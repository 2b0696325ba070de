"""Model assembly (port of ``repro.models.transformer``): layer kinds
``G`` (global attention), ``L`` (sliding-window attention) and ``M``
(the Mamba2 mixer), each followed by a gated MLP, the MoE FFN (every
cfg.moe_every-th layer of an MoE model) or nothing (mamba2's pure-mixer
blocks, d_ff == 0).

Depth is organised as in the reference: the layer pattern (cfg.pattern)
is one superblock, and every parameter and cache keeps the reference's
leading superblock dimension, so the reference's parameter tree converts
leaf for leaf (``schema.from_numpy``).  The reference scans over
superblocks; the port loops over them eagerly.

Encoder-decoder models (seamless) carry a stack of ``n_enc_layers``
encoder layers (``enc_blocks``, ``enc_norm``): ``encode`` runs them as
bidirectional self-attention through the cross-attention primitive, and
every non-``M`` decoder layer has ``ln_x``/``xattn`` leaves, which add
cross attention to ``enc_out`` after the mixer and before the FFN
wherever ``enc_out`` is given (the full forward, prefill and each decode
step; the cross K/V are projected anew in every call, as in the
reference).  Embedding-input models (pixtral) take ``embeds`` in place
of token ids in ``forward`` and ``prefill``, cast to ``lm_head``'s
dtype; decode always embeds tokens.

Decode is paged: each attention layer has a KV page pool indexed by block
tables that come from Honeycomb GETs (``serving/kv_cache.py``); each
mamba layer has its recurrent state and conv tail at the request's slot
row.  The reference keeps no cross-attention cache, nor does the port.

Training: ``lm_loss`` runs the full forward over the parameter tree (no
caches built) and its cross entropy; with ``remat`` (its default, as in
the reference) each superblock and each encoder layer runs under
activation checkpointing, the reference's ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as ll
from . import mamba2 as mm
from . import moe as me
from .config import ArchConfig
from .schema import ParamDef, map_tree, n_params, stack

F32 = torch.float32
KV_LEAVES = ("k_pages", "v_pages")


# ---------------------------------------------------------------- structure
def layer_kinds(cfg: ArchConfig) -> list[tuple[str, str | None]]:
    """[(mixer_kind, ffn_kind)] for one superblock."""
    out = []
    for i, kind in enumerate(cfg.pattern):
        if cfg.d_ff == 0:
            ffn = None
        elif cfg.n_experts and (i % cfg.moe_every == cfg.moe_every - 1
                                or cfg.moe_every == 1):
            ffn = "moe"
        else:
            ffn = "mlp"
        out.append((kind, ffn))
    return out


def _layer_schema(cfg: ArchConfig, kind: str, ffn: str | None):
    s: dict[str, Any] = {"ln1": ll.rmsnorm_schema(cfg.d_model)}
    if kind == "M":
        s["mamba"] = mm.mamba_schema(cfg)
    else:
        s["attn"] = ll.attention_schema(cfg)
    if cfg.n_enc_layers and kind != "M":
        s["ln_x"] = ll.rmsnorm_schema(cfg.d_model)
        s["xattn"] = ll.cross_attention_schema(cfg)
    if ffn is not None:
        s["ln2"] = ll.rmsnorm_schema(cfg.d_model)
        s["ffn"] = me.moe_schema(cfg) if ffn == "moe" else ll.mlp_schema(cfg)
    return s


def superblock_schema(cfg: ArchConfig):
    return {f"l{i}": _layer_schema(cfg, kind, ffn)
            for i, (kind, ffn) in enumerate(layer_kinds(cfg))}


def _encoder_layer_schema(cfg: ArchConfig):
    return {"ln1": ll.rmsnorm_schema(cfg.d_model),
            "attn": ll.attention_schema(cfg),
            "ln2": ll.rmsnorm_schema(cfg.d_model),
            "mlp": ll.mlp_schema(cfg)}


def schema(cfg: ArchConfig):
    d, v = cfg.d_model, cfg.vocab
    s: dict[str, Any] = {
        "embed": ParamDef((v, d), torch.bfloat16, "embed"),
        "blocks": stack(cfg.n_superblocks, superblock_schema(cfg)),
        "final_norm": ll.rmsnorm_schema(d),
        "lm_head": ParamDef((d, v)),
    }
    if cfg.n_enc_layers:
        s["enc_blocks"] = stack(cfg.n_enc_layers, _encoder_layer_schema(cfg))
        s["enc_norm"] = ll.rmsnorm_schema(d)
    return s


def moe_param_count(cfg: ArchConfig) -> int:
    """Expert parameters of the whole model (the routers excluded)."""
    if not cfg.n_experts:
        return 0
    per_layer = n_params(me.moe_schema(cfg)) - cfg.d_model * cfg.n_experts
    n_moe_layers = sum(1 for _, f in layer_kinds(cfg)
                       if f == "moe") * cfg.n_superblocks
    return per_layer * n_moe_layers


def _unstack(tree, n: int) -> list:
    """All ``n`` superblocks of a stacked tree (views), one ``unbind`` a
    leaf.  Under autograd its backward stacks the n gradients into the
    leaf's once, where n indexings ``t[i]`` would each add a zero-filled
    gradient of the whole stacked leaf (n passes over it)."""
    per = map_tree(lambda t: t.unbind(0), tree)
    return [map_tree(lambda u: u[i], per) for i in range(n)]


# ----------------------------------------------------------------- forward
def _ffn(p, x, cfg: ArchConfig, ffn: str | None, moe_impl="dense"):
    if ffn is None:
        return x
    h = ll.rmsnorm(p["ln2"], x)
    f = me.moe(p["ffn"], h, cfg, impl=moe_impl) if ffn == "moe" \
        else ll.mlp(p["ffn"], h)
    return x + f


def _xattn(p, x, cfg: ArchConfig, kind: str, enc_out):
    """Cross attention to ``enc_out`` on a non-``M`` layer, where given."""
    if enc_out is None or kind == "M":
        return x
    h = ll.rmsnorm(p["ln_x"], x)
    return x + ll.cross_attention(p["xattn"], h, enc_out, cfg)


def _layer(p, x, cfg: ArchConfig, kind: str, ffn: str | None,
           moe_impl="dense", last_pos=None, enc_out=None,
           build_cache=True):
    """One layer over a whole sequence: (x, cache), the cache (k, v) of an
    attention layer or the ``MambaState`` after ``last_pos`` [B] (the last
    position when None) of a mamba layer; None with ``build_cache=False``
    (the full forward and training, which build no mamba state)."""
    h = ll.rmsnorm(p["ln1"], x)
    cache = None
    if kind == "M" and not build_cache:
        y = mm.mamba_block(p["mamba"], h, cfg)
    elif kind == "M":
        y, cache = mm.mamba_block(p["mamba"], h, cfg, return_state=True,
                                  last_pos=last_pos)
    else:
        y, kv = ll.attention(p["attn"], h, cfg, local=(kind == "L"))
        cache = kv if build_cache else None
    x = _xattn(p, x + y, cfg, kind, enc_out)
    return _ffn(p, x, cfg, ffn, moe_impl), cache


def _embed(params, tokens, embeds):
    """Token embeddings, or ``embeds`` cast to ``lm_head``'s dtype (as in
    the reference: not ``embed``'s)."""
    if embeds is None:
        return params["embed"][tokens.long()]
    return embeds.to(params["lm_head"].dtype)


def _logits(params, cfg: ArchConfig, x):
    x = ll.rmsnorm(params["final_norm"], x)
    logits = torch.matmul(x, params["lm_head"]).to(F32)
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _run_layers(x, n: int, layer, remat: bool):
    """``x`` through ``layer(x, i)`` for i in 0 .. n-1; with ``remat`` each
    call runs under activation checkpointing (its activations recomputed
    in the backward pass), as the reference wraps its scanned body in
    ``jax.checkpoint``."""
    for i in range(n):
        x = checkpoint(layer, x, i, use_reentrant=False) if remat \
            else layer(x, i)
    return x


def forward(params, cfg: ArchConfig, tokens=None, moe_impl: str = "dense",
            embeds=None, enc_out=None, remat: bool = False):
    """Full forward over ``tokens`` [B, S] (or ``embeds`` [B, S, d]),
    cross-attending to ``enc_out`` [B, Senc, d] where given -> logits
    [B, S, V] (f32).  ``remat`` recomputes each superblock in the
    backward pass."""
    kinds = layer_kinds(cfg)
    blocks = _unstack(params["blocks"], cfg.n_superblocks)

    def superblock(x, i):
        blk = blocks[i]
        for j, (kind, ffn) in enumerate(kinds):
            x, _ = _layer(blk[f"l{j}"], x, cfg, kind, ffn, moe_impl,
                          enc_out=enc_out, build_cache=False)
        return x
    x = _run_layers(_embed(params, tokens, embeds), cfg.n_superblocks,
                    superblock, remat)
    return _logits(params, cfg, x)


def encode(params, cfg: ArchConfig, enc_embeds, remat: bool = False):
    """The encoder stack over ``enc_embeds`` [B, Senc, d] (cast to
    ``lm_head``'s dtype): per layer RMSNorm, bidirectional self-attention
    through the cross-attention primitive (no RoPE, no mask), the
    residual, the MLP; ``enc_norm`` last.  Returns [B, Senc, d].
    ``remat`` recomputes each layer in the backward pass."""
    layers = _unstack(params["enc_blocks"], cfg.n_enc_layers)

    def layer(x, i):
        p = layers[i]
        h = ll.rmsnorm(p["ln1"], x)
        x = x + ll.cross_attention(p["attn"], h, h, cfg)
        h = ll.rmsnorm(p["ln2"], x)
        return x + ll.mlp(p["mlp"], h)
    x = _run_layers(enc_embeds.to(params["lm_head"].dtype),
                    cfg.n_enc_layers, layer, remat)
    return ll.rmsnorm(params["enc_norm"], x)


def lm_loss(params, cfg: ArchConfig, batch, moe_impl: str = "dense",
            remat: bool = True):
    """Next-token cross entropy, the mean over positions whose label is
    >= 0.  ``batch``: {"tokens" | "embeds", "labels", ["enc_embeds"]}
    (tensors on the parameters' device).

    CE as logsumexp - gold logit, with no second [B, S, V] log-probability
    array beside the logits.  A negative label reads the gold logit at
    its index modulo V, as the reference's ``take_along_axis`` wraps -1
    to the last entry; the mask then zeroes its term."""
    enc_out = None
    if cfg.n_enc_layers:
        enc_out = encode(params, cfg, batch["enc_embeds"], remat=remat)
    logits = forward(params, cfg, batch.get("tokens"), moe_impl,
                     batch.get("embeds"), enc_out, remat=remat)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, (labels % cfg.vocab)[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)


class DecodeCache(NamedTuple):
    """Stacked per-superblock caches + shared block tables."""
    layers: Any          # {"l<i>": {"k_pages", "v_pages"} | {"ssm", "conv"}}
    block_tables: Any    # i32 [B, PPS] — Honeycomb page-table lookups
    seq_lens: Any        # i32 [B]


def prefill(params, cfg: ArchConfig, tokens=None, page_size: int = 256,
            last_pos=None, moe_impl: str = "dense", embeds=None,
            enc_out=None):
    """Forward over the prompt (``tokens`` [B, S] or ``embeds`` [B, S,
    d]), cross-attending to ``enc_out`` where given, returning last-token
    logits and the decode caches: KV pages (identity block tables) and
    mamba states.

    ``last_pos`` ([B] or scalar) selects which position's logits to
    return (page-padded prompts: the real last token, not the pad tail),
    and the position after which each mamba state is taken.
    Returns (logits [B, V], DecodeCache)."""
    x = _embed(params, tokens, embeds)
    B, S, _ = x.shape
    if S % page_size:
        raise ValueError(f"prompt length {S} is not a multiple of the page "
                         f"size {page_size}")
    pps = S // page_size
    kv_shape = (B * pps, page_size, cfg.n_kv_heads, cfg.head_dim)
    idx = None if last_pos is None else \
        torch.as_tensor(last_pos, device=x.device).long().expand(B)
    kinds = layer_kinds(cfg)
    caches: dict[str, dict[str, list]] = {f"l{j}": {}
                                          for j in range(len(kinds))}
    for blk in _unstack(params["blocks"], cfg.n_superblocks):
        for j, (kind, ffn) in enumerate(kinds):
            x, c = _layer(blk[f"l{j}"], x, cfg, kind, ffn, moe_impl, idx,
                          enc_out)
            if kind == "M":
                new = {"ssm": c.ssm, "conv": c.conv}
            else:
                new = {"k_pages": c[0].reshape(kv_shape),
                       "v_pages": c[1].reshape(kv_shape)}
            for n, t in new.items():
                caches[f"l{j}"].setdefault(n, []).append(t)
    layers = {name: {n: torch.stack(ts) for n, ts in c.items()}
              for name, c in caches.items()}
    if idx is None:
        xl = x[:, -1:]
    else:
        xl = x[torch.arange(B, device=x.device), idx][:, None]
    logits = _logits(params, cfg, xl)
    block_tables = torch.arange(B * pps, dtype=torch.int32,
                                device=x.device).reshape(B, pps)
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits[:, 0], DecodeCache(layers, block_tables, seq_lens)


# ------------------------------------------------------------------ decode
def layer_cache_schema(cfg: ArchConfig, batch: int, pages_per_seq: int,
                       page_size: int):
    """ParamDef tree for one superblock's caches (stacked by the caller):
    KV page pools of ``batch * pages_per_seq`` pages for attention layers,
    a state and a conv tail per batch row for mamba layers (no
    cross-attention cache: decode projects ``enc_out`` anew, as in the
    reference)."""
    n_pages = batch * pages_per_seq
    kv = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    out = {}
    for i, (kind, _) in enumerate(layer_kinds(cfg)):
        if kind == "M":
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            out[f"l{i}"] = {
                "ssm": ParamDef((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state), F32, "zeros"),
                "conv": ParamDef((batch, cfg.conv_width - 1, conv_dim), F32,
                                 "zeros"),
            }
        else:
            out[f"l{i}"] = {"k_pages": ParamDef(kv), "v_pages": ParamDef(kv)}
    return out


def decode_step(params, cfg: ArchConfig, cache: DecodeCache, tokens,
                page_size: int, attn=None, enc_out=None):
    """One decode token for the whole batch: tokens [B, 1] int.  The pools
    and mamba states of ``cache.layers`` are updated in place.  ``attn``
    is the paged attention (``kernels/ops.paged_attention`` when None).
    The MoE FFN is the dense one, as in the reference.  With ``enc_out``
    [B, Senc, d], each non-``M`` layer cross-attends to all Senc frames
    (no ``ctx_lens``, as in the reference).
    Returns (logits [B, V], DecodeCache with seq_lens + 1)."""
    x = params["embed"][tokens.long()]
    bt, lens = cache.block_tables, cache.seq_lens
    kinds = layer_kinds(cfg)
    n = cfg.n_superblocks
    for blk, pools in zip(_unstack(params["blocks"], n),
                          _unstack(cache.layers, n)):
        for j, (kind, ffn) in enumerate(kinds):
            p, c = blk[f"l{j}"], pools[f"l{j}"]
            h = ll.rmsnorm(p["ln1"], x)
            if kind == "M":
                y, st = mm.mamba_decode(
                    p["mamba"], h, mm.MambaState(c["ssm"], c["conv"]), cfg)
                c["ssm"].copy_(st.ssm)
                c["conv"].copy_(st.conv)    # the tail in x's dtype, widened
            else:
                y, _ = ll.decode_attention(
                    p["attn"], h, cfg, c["k_pages"], c["v_pages"], bt, lens,
                    local=(kind == "L"), page_size=page_size, attn=attn)
            x = _ffn(p, _xattn(p, x + y, cfg, kind, enc_out), cfg, ffn)
    return _logits(params, cfg, x)[:, 0], DecodeCache(cache.layers, bt,
                                                      lens + 1)


# ------------------------------------------------------------------ module
class _Tree(nn.Module):
    """A nested dict of tensors as buffers and submodules."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_buffer(k, v)

    def tree(self):
        out = dict(self._buffers)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


class Transformer(nn.Module):
    """One model's parameter tree as an ``nn.Module`` for serving (the
    leaves are buffers), with ``forward``, ``encode``, ``prefill`` and
    ``decode_step`` under ``torch.inference_mode``.  Training does not go
    through it: ``lm_loss`` is a function of the parameter tree, whose
    leaves require grad (``launch/steps.train_step``)."""

    def __init__(self, cfg: ArchConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params_tree = _Tree(params)

    @property
    def params(self):
        return self.params_tree.tree()

    @torch.inference_mode()
    def forward(self, tokens=None, moe_impl: str = "dense", embeds=None,
                enc_out=None):
        return forward(self.params, self.cfg, tokens, moe_impl, embeds,
                       enc_out)

    @torch.inference_mode()
    def encode(self, enc_embeds):
        return encode(self.params, self.cfg, enc_embeds)

    @torch.inference_mode()
    def prefill(self, tokens=None, page_size: int = 256, last_pos=None,
                moe_impl: str = "dense", embeds=None, enc_out=None):
        return prefill(self.params, self.cfg, tokens, page_size, last_pos,
                       moe_impl, embeds, enc_out)

    @torch.inference_mode()
    def decode_step(self, cache: DecodeCache, tokens, page_size: int,
                    attn=None, enc_out=None):
        return decode_step(self.params, self.cfg, cache, tokens, page_size,
                           attn, enc_out)
