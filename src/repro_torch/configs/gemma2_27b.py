"""gemma2-27b [dense] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    pattern="LG", window=4096, attn_softcap=50.0, final_softcap=30.0,
    notes="local+global alternating, logit softcaps [arXiv:2408.00118].")

SMOKE_CONFIG = ArchConfig(
    arch_id="gemma2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, pattern="LG", window=32, attn_softcap=50.0,
    final_softcap=30.0)
