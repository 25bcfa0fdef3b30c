"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d, GQA.  [arXiv:2406.12793; hf]

Copy of ``repro/configs/chatglm3_6b.py`` with the published widths as they
are.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=65024,
    rope_variant="rope2d",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab_size=512,
    rope_variant="rope2d",
    tie_embeddings=False,
)
