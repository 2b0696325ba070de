"""The yardstick's counts: the card's peaks, the useful FLOPs a token
costs, and the bytes a paged-attention launch has to move.  They are
worked out from the configuration's ``arch`` block, the traffic's live
lengths and the structure that the configuration's plain reference
module ``ref`` (``harness.reference_module``) gives: its ``layout``,
``layer_kinds``, ``n_periods``, and ``ssm_flops`` where it has one (else
``ssm_dims``), whatever implements them."""
from __future__ import annotations

import math

from .weights import leaves

#: NVIDIA H100 SXM data sheet, dense (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def active_body_params(ref, arch: dict) -> float:
    """Parameters a token passes through outside the embedding and the
    head: every leaf of the layers, an expert stack's at top_k of
    n_experts."""
    total = 0.0
    for path, (shape, _, _) in leaves(ref.layout(arch)["blocks"]):
        n = math.prod(shape)
        if path[-2] == "ffn" and len(shape) == 4:      # [periods, E, .., ..]
            n *= arch["top_k"] / arch["n_experts"]
        total += n
    return total


def _n_kinds(ref, arch: dict, kind: str) -> int:
    return sum(k == kind for k, _ in ref.layer_kinds(arch)) \
        * ref.n_periods(arch)


def _attn_flops(ref, arch: dict, keys: float) -> float:
    """QK^T and PV of queries attending to ``keys`` positions in all."""
    return 4.0 * arch["n_heads"] * arch["head_dim"] * keys \
        * _n_kinds(ref, arch, "G")


def ssm_flops(ref, arch: dict) -> float:
    """Each token's FLOPs in the conv and scan of every Mamba layer: the
    module's own ``ssm_flops(arch)`` where it has one, else one B/C group
    of ``ssm_dims``."""
    if hasattr(ref, "ssm_flops"):
        return ref.ssm_flops(arch)
    if not _n_kinds(ref, arch, "M"):
        return 0.0
    din, nh, p, ns = ref.ssm_dims(arch)
    return (2 * arch.get("conv_width", 4) * (din + 2 * ns)
            + 6 * nh * p * ns) * _n_kinds(ref, arch, "M")


def _head_flops(arch: dict) -> float:
    return 2.0 * arch["d_model"] * arch["vocab"]


def decode_flops(ref, arch: dict, tokens: int, keys: int) -> float:
    """Useful FLOPs of a decode step that produced ``tokens`` tokens,
    attending to ``keys`` positions in all (each its own included): 2 per
    active parameter and per head weight a token, QK^T and PV in each
    attention layer, each Mamba layer's conv and scan."""
    return (2 * active_body_params(ref, arch) + _head_flops(arch)
            + ssm_flops(ref, arch)) * tokens + _attn_flops(ref, arch, keys)


def prefill_flops(ref, arch: dict, s: int) -> float:
    """Useful FLOPs of a prefill of ``s`` prompt tokens: every token's
    layers, causal attention over 1..s keys, the head once (the logits of
    the last token only)."""
    return (2 * active_body_params(ref, arch) + ssm_flops(ref, arch)) * s \
        + _attn_flops(ref, arch, s * (s + 1) / 2) + _head_flops(arch)


def paged_attention_bytes(arch: dict, keys: int, rows: int) -> int:
    """Bytes one paged-attention launch must move: K and V of the
    ``keys`` visible positions of its ``rows`` rows (an idle row sees
    one), each row's query and output, in bf16."""
    kv = arch["n_kv_heads"] * arch["head_dim"] * BF16
    qo = arch["n_heads"] * arch["head_dim"] * BF16
    return keys * 2 * kv + rows * 2 * qo


def attention_layers(ref, arch: dict) -> int:
    return _n_kinds(ref, arch, "G")
