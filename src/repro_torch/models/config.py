"""Architecture configuration (port of ``repro.models.config``).

The same frozen dataclass as the reference, field for field, and its
shape table with ``shape_by_name``.  ``param_count`` and
``active_param_count`` go through the port's own schema
(``models/transformer.py``), encoders and cross attention included.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int                    # padded to shardable multiple; see configs
    raw_vocab: int = 0            # the published vocab before padding

    # attention features
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: int = 0               # sliding-window size for local layers
    # layer pattern, repeated across depth: 'G' global attn, 'L' local attn,
    # 'M' mamba block.  Must divide n_layers.
    pattern: str = "G"
    attn_softcap: float = 0.0     # gemma2-style logit soft-capping
    final_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1            # MoE MLP every k-th layer (jamba: 2)
    capacity_factor: float = 1.25

    # SSM (mamba2 / jamba mamba layers)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    # encoder-decoder (seamless)
    n_enc_layers: int = 0         # 0 => decoder-only
    enc_seq_divisor: int = 8      # encoder frames = seq // divisor

    # modality frontend stub: inputs arrive as embeddings, not token ids
    embeds_in: bool = False

    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.arch_id}: pattern {self.pattern!r} must "
                             f"divide n_layers={self.n_layers}")
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        """Total parameters (analytic, from the port's schema)."""
        from . import transformer
        from .schema import n_params
        return n_params(transformer.schema(self))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        total = self.param_count()
        if not self.n_experts:
            return total
        from . import transformer
        moe = transformer.moe_param_count(self)
        return total - moe + int(moe * self.top_k / self.n_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                     # train_4k | prefill_32k | ...
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int
    page_size: int = 256          # KV page granularity (honeycomb-indexed)


LM_SHAPES = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def long_context_ok(cfg: ArchConfig) -> bool:
    """long_500k runs only for sub-quadratic families (DESIGN.md Section 6)."""
    return cfg.family in ("ssm", "hybrid")
