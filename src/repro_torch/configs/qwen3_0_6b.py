"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-0.6B; hf]

Copy of ``repro/configs/qwen3_0_6b.py`` with the published widths as they
are."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,  # explicit head dim (16·128 = 2048 > d_model, per Qwen3)
    d_ff=3072,
    vocab_size=151936,
    rope_variant="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,  # head dim decoupled from d_model/n_heads, like the real arch
    d_ff=128,
    vocab_size=512,
    rope_variant="rope",
    qk_norm=True,
    tie_embeddings=True,
)
