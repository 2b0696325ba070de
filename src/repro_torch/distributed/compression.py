"""Gradient compression with error feedback (port of
``repro.distributed.compression``): symmetric per-tensor int8 and top-k
sparsification, and ``GradCompressor``, which carries the residual as
explicit state (a parameters-shaped tree) so the step stays functional.
It is the optimizer's ``grad_transform`` hook: in the reference it
compresses the cross-pod hop of the gradient all-reduce, which one card
does not have (ROADMAP A, item 6, keeps the mesh).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import schema as sc

F32 = torch.float32


def int8_quantize(x: torch.Tensor):
    """Symmetric per-tensor int8: (q, scale).  ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor):
    return q.to(F32) * scale


def topk_sparsify(x: torch.Tensor, frac: float):
    """Keep the largest-|x| fraction (every entry tied with the k-th
    largest too); returns (sparse x, kept mask)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    mask = torch.abs(x) >= thresh
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)), mask


class CompressorState(NamedTuple):
    residual: object     # parameters-shaped tree of f32 residuals


class GradCompressor:
    """Error-feedback compressor: g' = C(g + r); r <- (g + r) - g'."""

    def __init__(self, mode: str = "int8", topk_frac: float = 0.02):
        if mode not in ("int8", "topk", "none"):
            raise ValueError(f"unknown compression mode {mode!r}")
        self.mode = mode
        self.topk_frac = topk_frac

    def init(self, params) -> CompressorState:
        return CompressorState(residual=sc.map_tree(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
            params))

    def __call__(self, grads, state: CompressorState):
        if self.mode == "none":
            return grads, state

        def comp(g, r):
            x = g.to(F32) + r
            if self.mode == "int8":
                out = int8_dequantize(*int8_quantize(x))
            else:
                out, _ = topk_sparsify(x, self.topk_frac)
            return out, x - out

        pairs = sc.map_tree(comp, grads, state.residual)
        outs = sc.map_tree(lambda _, t: t[0], grads, pairs)
        res = sc.map_tree(lambda _, t: t[1], grads, pairs)
        return outs, CompressorState(residual=res)

    def wire_bytes_per_value(self) -> float:
        """Bytes on the wire per gradient value (roofline accounting)."""
        return {"int8": 1.0,
                "topk": 8.0 * self.topk_frac,   # value+index pairs
                "none": 4.0}[self.mode]
