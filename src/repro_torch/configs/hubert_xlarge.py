"""hubert-xlarge [audio] — 48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 — encoder-only, same arch as w2v2.  [arXiv:2106.07447; unverified]

Backbone only: the CNN feature extractor is a stub (``input_specs`` provides
precomputed frame embeddings).  Encoder-only: bidirectional attention,
LayerNorm + GELU MLP, no decode step (decode shapes are skipped).

Copy of ``repro/configs/hubert_xlarge.py`` with the published widths as they
are.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab_size=504,
    rope_variant="none",
    causal=False,
    norm="ln",
    embed_inputs=False,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=64,
    rope_variant="none",
    causal=False,
    norm="ln",
    embed_inputs=False,
    tie_embeddings=False,
)
