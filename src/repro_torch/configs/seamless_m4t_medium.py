"""seamless-m4t-medium [audio] — exact assigned config + reduced smoke
config."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256256, raw_vocab=256206,
    pattern="G", n_enc_layers=12, enc_seq_divisor=8, embeds_in=False,
    notes="encoder-decoder; audio frontend is a STUB (input_specs provides "
          "frame embeddings); vocab padded 256206->256256 "
          "[arXiv:2308.11596].")

SMOKE_CONFIG = ArchConfig(
    arch_id="seamless-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, pattern="G", n_enc_layers=2)
