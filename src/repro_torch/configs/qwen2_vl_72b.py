"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone only, per the assignment: the vision frontend is a stub —
``input_specs`` provides precomputed patch embeddings [B, S, d_model];
M-RoPE (3-section rotary: temporal/height/width) runs on stub positions.

Copy of ``repro/configs/qwen2_vl_72b.py`` with the published widths as they
are.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab_size=152064,
    rope_variant="mrope",
    rope_theta=1_000_000.0,
    embed_inputs=False,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab_size=512,
    rope_variant="mrope",
    embed_inputs=False,
    tie_embeddings=False,
)
