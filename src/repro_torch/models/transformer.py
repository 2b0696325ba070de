"""Model assembly (port of ``repro.models.transformer``) for the dense
attention stacks: layer kinds ``G`` (global attention) and ``L``
(sliding-window attention), each with a gated-MLP FFN.

Depth is organised as in the reference: the layer pattern (cfg.pattern)
is one superblock, and every parameter and KV pool keeps the reference's
leading superblock dimension, so the reference's parameter tree converts
leaf for leaf (``schema.from_numpy``).  The reference scans over
superblocks; the port loops over them eagerly.

Decode is paged: each attention layer has a KV page pool indexed by block
tables that come from Honeycomb GETs (``serving/kv_cache.py``).  Not
ported (ROADMAP A11): mamba layers (``M``), the MoE FFN and
encoder-decoder models; their schemas raise.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from . import layers as ll
from .config import ArchConfig
from .schema import ParamDef, map_tree, stack

F32 = torch.float32


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


def _check_ported(cfg: ArchConfig) -> None:
    for kind, ffn in layer_kinds(cfg):
        if kind not in ("G", "L"):
            raise NotImplementedError(
                f"{cfg.arch_id}: layer kind {kind!r} is not ported "
                f"(ROADMAP A11)")
        if ffn == "moe":
            raise NotImplementedError(
                f"{cfg.arch_id}: the MoE FFN is not ported (ROADMAP A11)")
    if cfg.n_enc_layers or cfg.embeds_in:
        raise NotImplementedError(
            f"{cfg.arch_id}: encoders and embedding inputs are not ported "
            f"(ROADMAP A11)")


def _layer_schema(cfg: ArchConfig, ffn: str | None):
    s: dict[str, Any] = {"ln1": ll.rmsnorm_schema(cfg.d_model),
                         "attn": ll.attention_schema(cfg)}
    if ffn is not None:
        s["ln2"] = ll.rmsnorm_schema(cfg.d_model)
        s["ffn"] = ll.mlp_schema(cfg)
    return s


def superblock_schema(cfg: ArchConfig):
    _check_ported(cfg)
    return {f"l{i}": _layer_schema(cfg, ffn)
            for i, (_, ffn) in enumerate(layer_kinds(cfg))}


def schema(cfg: ArchConfig):
    d, v = cfg.d_model, cfg.vocab
    return {
        "embed": ParamDef((v, d), torch.bfloat16, "embed"),
        "blocks": stack(cfg.n_superblocks, superblock_schema(cfg)),
        "final_norm": ll.rmsnorm_schema(d),
        "lm_head": ParamDef((d, v)),
    }


def _at(tree, i: int):
    """Superblock ``i`` of a stacked tree (views)."""
    return map_tree(lambda t: t[i], tree)


# ----------------------------------------------------------------- forward
def _layer(p, x, cfg: ArchConfig, kind: str, ffn: str | None):
    """One layer over a whole sequence: (x, (k, v))."""
    h = ll.rmsnorm(p["ln1"], x)
    a, kv = ll.attention(p["attn"], h, cfg, local=(kind == "L"))
    x = x + a
    if ffn is not None:
        x = x + ll.mlp(p["ffn"], ll.rmsnorm(p["ln2"], x))
    return x, kv


def _logits(params, cfg: ArchConfig, x):
    x = ll.rmsnorm(params["final_norm"], x)
    logits = torch.matmul(x, params["lm_head"]).to(F32)
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def forward(params, cfg: ArchConfig, tokens):
    """Full forward over ``tokens`` [B, S] -> logits [B, S, V] (f32)."""
    x = params["embed"][tokens.long()]
    kinds = layer_kinds(cfg)
    for i in range(cfg.n_superblocks):
        blk = _at(params["blocks"], i)
        for j, (kind, ffn) in enumerate(kinds):
            x, _ = _layer(blk[f"l{j}"], x, cfg, kind, ffn)
    return _logits(params, cfg, x)


class DecodeCache(NamedTuple):
    """Stacked per-superblock KV pools + shared block tables."""
    layers: Any          # {"l<i>": {"k_pages", "v_pages"}}, [n_sb, NP, ...]
    block_tables: Any    # i32 [B, PPS] — Honeycomb page-table lookups
    seq_lens: Any        # i32 [B]


def prefill(params, cfg: ArchConfig, tokens, page_size: int = 256,
            last_pos=None):
    """Forward over the prompt, returning last-token logits and the KV
    pages (identity block tables).

    ``last_pos`` ([B] or scalar) selects which position's logits to
    return (page-padded prompts: the real last token, not the pad tail).
    Returns (logits [B, V], DecodeCache)."""
    x = params["embed"][tokens.long()]
    B, S, _ = x.shape
    if S % page_size:
        raise ValueError(f"prompt length {S} is not a multiple of the page "
                         f"size {page_size}")
    pps = S // page_size
    kv_shape = (B * pps, page_size, cfg.n_kv_heads, cfg.head_dim)
    kinds = layer_kinds(cfg)
    pools = {f"l{j}": {"k_pages": [], "v_pages": []}
             for j in range(len(kinds))}
    for i in range(cfg.n_superblocks):
        blk = _at(params["blocks"], i)
        for j, (kind, ffn) in enumerate(kinds):
            x, (k, v) = _layer(blk[f"l{j}"], x, cfg, kind, ffn)
            pools[f"l{j}"]["k_pages"].append(k.reshape(kv_shape))
            pools[f"l{j}"]["v_pages"].append(v.reshape(kv_shape))
    layers = {name: {n: torch.stack(ts) for n, ts in c.items()}
              for name, c in pools.items()}
    if last_pos is None:
        xl = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, device=x.device).long()
        xl = x[torch.arange(B, device=x.device), idx.expand(B)][:, None]
    logits = _logits(params, cfg, xl)
    block_tables = torch.arange(B * pps, dtype=torch.int32,
                                device=x.device).reshape(B, pps)
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits[:, 0], DecodeCache(layers, block_tables, seq_lens)


# ------------------------------------------------------------------ decode
def layer_cache_schema(cfg: ArchConfig, batch: int, pages_per_seq: int,
                       page_size: int):
    """ParamDef tree for one superblock's KV pools (stacked by the
    caller)."""
    _check_ported(cfg)
    n_pages = batch * pages_per_seq
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {f"l{i}": {"k_pages": ParamDef(shape), "v_pages": ParamDef(shape)}
            for i in range(len(cfg.pattern))}


def decode_step(params, cfg: ArchConfig, cache: DecodeCache, tokens,
                page_size: int, attn=None):
    """One decode token for the whole batch: tokens [B, 1] int.  The pools
    of ``cache.layers`` are updated in place.  ``attn`` is the paged
    attention (``kernels/ops.paged_attention`` when None).
    Returns (logits [B, V], DecodeCache with seq_lens + 1)."""
    x = params["embed"][tokens.long()]
    bt, lens = cache.block_tables, cache.seq_lens
    kinds = layer_kinds(cfg)
    for i in range(cfg.n_superblocks):
        blk = _at(params["blocks"], i)
        pools = _at(cache.layers, i)
        for j, (kind, ffn) in enumerate(kinds):
            p, c = blk[f"l{j}"], pools[f"l{j}"]
            y, _ = ll.decode_attention(
                p["attn"], ll.rmsnorm(p["ln1"], x), cfg, c["k_pages"],
                c["v_pages"], bt, lens, local=(kind == "L"),
                page_size=page_size, attn=attn)
            x = x + y
            if ffn is not None:
                x = x + ll.mlp(p["ffn"], ll.rmsnorm(p["ln2"], x))
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
    """One model's parameter tree as an ``nn.Module`` (the leaves are
    buffers: the port serves, it does not train), with ``forward``,
    ``prefill`` and ``decode_step`` under ``torch.inference_mode``."""

    def __init__(self, cfg: ArchConfig, params):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.params_tree = _Tree(params)

    @property
    def params(self):
        return self.params_tree.tree()

    @torch.inference_mode()
    def forward(self, tokens):
        return forward(self.params, self.cfg, tokens)

    @torch.inference_mode()
    def prefill(self, tokens, page_size: int, last_pos=None):
        return prefill(self.params, self.cfg, tokens, page_size, last_pos)

    @torch.inference_mode()
    def decode_step(self, cache: DecodeCache, tokens, page_size: int,
                    attn=None):
        return decode_step(self.params, self.cfg, cache, tokens, page_size,
                           attn)
