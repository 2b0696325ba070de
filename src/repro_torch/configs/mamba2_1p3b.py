"""mamba2-1.3b [ssm] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=1, head_dim=0,
    d_ff=0, vocab=50304, raw_vocab=50280,
    pattern="M", ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    notes="SSD (state-space duality), attention-free [arXiv:2405.21060]; "
          "vocab padded 50280->50304 (model-axis multiple).")

SMOKE_CONFIG = ArchConfig(
    arch_id="mamba2-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=0, n_kv_heads=1, head_dim=0,
    d_ff=0, vocab=256, pattern="M", ssm_state=16, ssm_head_dim=16,
    ssm_expand=2)
