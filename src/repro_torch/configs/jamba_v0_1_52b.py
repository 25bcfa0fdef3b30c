"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Groups of 8 sublayers: 7 Mamba2 + 1 attention (1:7); FFNs alternate dense /
MoE (MoE every other layer, 16 experts top-2).  The ``long`` variant enables
sliding-window attention on the (rare) attention layers so the 500k decode
shape stays sub-quadratic.

Copy of ``repro/configs/jamba_v0_1_52b.py`` with the published widths as they
are.
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    attn_every=8,
    ssm_state=128,
    ssm_heads=128,  # inner width 2·d_model = 8192, head dim 64
    ssm_d_head=64,
    rope_variant="rope",
    tie_embeddings=False,
)

# long-context variant: windowed attention on attention sublayers
LONG = dataclasses.replace(CONFIG, window=4096)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    moe_d_ff=128,
    vocab_size=512,
    n_experts=4,
    top_k=2,
    attn_every=4,
    ssm_state=16,
    ssm_heads=8,
    ssm_d_head=16,
    ssm_chunk=32,
    rope_variant="rope",
    tie_embeddings=False,
)
