"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

Copy of ``repro/configs/mistral_large_123b.py`` with the published widths as they
are.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    rope_variant="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab_size=512,
    rope_variant="rope",
    tie_embeddings=False,
)
