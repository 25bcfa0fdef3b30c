"""Model configuration without JAX: the fields the model, the memory-program
synthesis and the analytic parameter counts read.

Port of ``repro/models/model.py:ModelConfig`` for the dense and the ssm
(Mamba2) families.  The reference counts parameters by ``jax.eval_shape``
over the model's init; this port counts them from the shapes
``repro/models/transformer.py`` (and ``layers.py``, ``attention.py``,
``mamba2.py``) initialize.  The other families (MoE, hybrid, VLM, audio)
arrive with later cuts of the model zoo (slice 7 of the port).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["ModelConfig"]

CONV_K = 4  # Mamba2's depthwise causal conv width (repro/models/mamba2.py)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config fields that the dense and ssm families read
    (the MoE and hybrid fields arrive with those families)."""

    name: str
    family: str  # 'dense' | 'ssm' here; 'moe' | 'hybrid' | 'vlm' | 'audio' later in slice 7
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 => d_model // n_heads
    rope_variant: str = "rope"  # 'rope' | 'rope2d' | 'mrope' | 'none'
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None  # sliding-window span (attention layers)
    attn_block_q: int = 1024  # chunked_attention's query block
    attn_block_k: int = 1024  # chunked_attention's key block
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_head: int = 64
    ssm_chunk: int = 128
    # --- embeddings / misc ---
    tie_embeddings: bool = True
    embed_inputs: bool = True  # False: step takes precomputed embeddings
    norm: str = "rms"  # 'rms' | 'ln'
    mlp_gated: bool = True  # False: plain 2-matrix GELU MLP
    pad_vocab_to_multiple: int = 0
    dtype: torch.dtype = torch.bfloat16  # activations
    cache_dtype: torch.dtype = torch.bfloat16  # KV caches (the SSM caches stay f32)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to_multiple
        if m and self.vocab_size % m:
            return self.vocab_size + (m - self.vocab_size % m)
        return self.vocab_size

    def group_spec(self) -> Tuple[Tuple[str, Optional[str]], ...]:
        """((mixer, ffn), ...) for one group: attention + MLP (dense), or one
        Mamba2 layer with an MLP only when ``d_ff > 0`` (ssm)."""
        if self.family == "dense":
            return (("attn", "mlp"),)
        if self.family == "ssm":
            return (("mamba", None if self.d_ff == 0 else "mlp"),)
        raise NotImplementedError(
            f"family {self.family!r} comes with a later cut of the model zoo "
            "(slice 7 of the port); 'dense' and 'ssm' are described"
        )

    @property
    def group_size(self) -> int:
        return len(self.group_spec())

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.group_size:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by group "
                f"size {self.group_size}"
            )
        return self.n_layers // self.group_size

    @property
    def attn_layers_per_group(self) -> int:
        return sum(1 for m, _ in self.group_spec() if m == "attn")

    @property
    def mamba_layers_per_group(self) -> int:
        return sum(1 for m, _ in self.group_spec() if m == "mamba")

    # ------------------------------------------------------------------ #
    # parameter accounting (analytic, from the reference's init shapes)
    # ------------------------------------------------------------------ #

    def param_counts(self) -> Dict[str, float]:
        """``{'total', 'active', 'expert'}`` parameter counts.

        The sum of every leaf the reference's ``Model.init`` creates —
        embedding, per-layer norms, the mixer (attention projections and
        q/k norms, or Mamba2's ``in_proj``, ``conv_w``, ``A_log``,
        ``dt_bias``, ``D``, ``norm`` and ``out_proj``), the MLP, the final
        norm and an untied head.  Equal to the reference's ``eval_shape``
        count exactly.
        """
        d, hd = self.d_model, self.d_head
        norm = 2 * d if self.norm == "ln" else d  # ln: gain + bias
        gated = self.norm != "ln" and self.mlp_gated
        mixer = {
            "attn": (
                d * self.n_heads * hd  # wq
                + 2 * d * self.n_kv_heads * hd  # wk, wv
                + self.n_heads * hd * d  # wo
                + (2 * hd if self.qk_norm else 0)  # q_norm, k_norm
            ),
            "mamba": self._mamba_params(),
        }
        group = 0
        for mix, ffn in self.group_spec():
            group += norm + mixer[mix]
            if ffn == "mlp":
                group += norm + (3 if gated else 2) * d * self.d_ff  # wi (+ wu) + wo
        total = self.n_groups * group + norm  # + final norm
        if self.embed_inputs:
            total += self.padded_vocab * d
        if not self.tie_embeddings or not self.embed_inputs:
            total += d * self.padded_vocab  # lm_head
        return {"total": float(total), "active": float(total), "expert": 0.0}

    def _mamba_params(self) -> int:
        d, h, n = self.d_model, self.ssm_heads, self.ssm_state
        di = h * self.ssm_d_head  # inner width
        return (
            d * (2 * di + 2 * n + h)  # in_proj -> [z, x, B, C, dt]
            + CONV_K * di  # conv_w
            + 3 * h  # A_log, dt_bias, D
            + di  # norm
            + di * d  # out_proj
        )
