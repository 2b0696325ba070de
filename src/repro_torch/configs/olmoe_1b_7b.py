"""olmoe-1b-7b [moe] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304,
    pattern="G", n_experts=64, top_k=8,
    notes="64 experts top-8 [arXiv:2409.02060].")

SMOKE_CONFIG = ArchConfig(
    arch_id="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab=256, pattern="G", n_experts=8, top_k=2)
