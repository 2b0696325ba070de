"""stablelm-3b [dense] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
    pattern="G",
    notes="dense MHA [hf:stabilityai/stablelm].")

SMOKE_CONFIG = ArchConfig(
    arch_id="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, pattern="G")
