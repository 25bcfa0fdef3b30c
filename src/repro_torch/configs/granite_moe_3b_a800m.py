"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Every layer is MoE (interleave 1); expert hidden width is 512.

Copy of ``repro/configs/granite_moe_3b_a800m.py`` with the published widths as they
are.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    moe_interleave=1,
    rope_variant="rope",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    moe_d_ff=64,
    vocab_size=512,
    n_experts=8,
    top_k=2,
    moe_interleave=1,
    rope_variant="rope",
    tie_embeddings=True,
)
