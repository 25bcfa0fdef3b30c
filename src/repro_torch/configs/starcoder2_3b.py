"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173; hf]

Copy of ``repro/configs/starcoder2_3b.py`` with the published widths as they
are.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab_size=49152,
    rope_variant="rope",
    mlp_gated=False,  # StarCoder2 uses a plain GELU MLP
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab_size=512,
    rope_variant="rope",
    mlp_gated=False,
    tie_embeddings=True,
)
