"""mixtral-8x22b [moe] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    pattern="L", window=4096, n_experts=8, top_k=2,
    rope_theta=1e6,
    notes="8 experts top-2, sliding-window attention [arXiv:2401.04088].")

SMOKE_CONFIG = ArchConfig(
    arch_id="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, pattern="L", window=32, n_experts=4, top_k=2)
