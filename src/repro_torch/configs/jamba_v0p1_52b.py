"""jamba-v0.1-52b [hybrid] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    pattern="MMMGMMMM", n_experts=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    notes="Mamba+attention 1:7 interleave, MoE 16e top-2 every other layer "
          "[arXiv:2403.19887]; mamba layers use the SSD formulation "
          "(DESIGN.md hardware-adaptation note).")

SMOKE_CONFIG = ArchConfig(
    arch_id="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, pattern="MMMGMMMM", n_experts=4, top_k=2,
    moe_every=2, ssm_state=16, ssm_head_dim=16)
