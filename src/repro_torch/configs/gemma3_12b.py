"""gemma3-12b [dense] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    pattern="LLLLLG", window=1024, rope_theta=1e6,
    notes="5:1 local:global, 128k context [hf:google/gemma-3].")

SMOKE_CONFIG = ArchConfig(
    arch_id="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, pattern="LLLLLG", window=16, rope_theta=1e6)
