"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Copy of ``repro/configs/mamba2_2_7b.py`` with the published widths as they
are.  Pure Mamba2: no attention, no MLP (d_ff=0); inner width 2·d_model =
5120, 80 heads of 64.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=80,
    ssm_d_head=64,
    rope_variant="none",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_head=16,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_heads=8,
    ssm_d_head=16,
    ssm_chunk=32,
    rope_variant="none",
    tie_embeddings=True,
)
