"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Maverick interleaves dense and MoE layers 1:1 (moe_interleave=2) and adds a
shared expert on MoE layers; with 128 routed experts top-1 this lands at
~400B total / ~17B active.

Copy of ``repro/configs/llama4_maverick_400b_a17b.py`` with the published widths as they
are.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    moe_d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    moe_interleave=2,
    shared_expert=True,
    rope_variant="rope",
    rope_theta=500_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama4-maverick-400b-a17b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    moe_d_ff=128,
    vocab_size=512,
    n_experts=8,
    top_k=1,
    moe_interleave=2,
    shared_expert=True,
    rope_variant="rope",
    tie_embeddings=False,
)
