"""pixtral-12b [vlm] — exact assigned config + reduced smoke config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    pattern="G", rope_theta=1e6, embeds_in=True,
    notes="pixtral-ViT frontend is a STUB (input_specs provides patch "
          "embeddings); backbone = mistral-nemo geometry "
          "[hf:mistralai/Pixtral-12B-2409].")

SMOKE_CONFIG = ArchConfig(
    arch_id="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, pattern="G", embeds_in=True)
