"""qwen2.5-3b [dense] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936,
    pattern="G", qkv_bias=True, rope_theta=1e6,
    notes="GQA kv=2, QKV bias [hf:Qwen/Qwen2.5].")

SMOKE_CONFIG = ArchConfig(
    arch_id="qwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, pattern="G", qkv_bias=True)
