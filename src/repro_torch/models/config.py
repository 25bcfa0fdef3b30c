"""Model configuration without JAX: the fields the memory-program synthesis
reads, and analytic parameter counts.

Port of ``repro/models/model.py:ModelConfig`` for the dense family.  The
reference counts parameters by ``jax.eval_shape`` over the model's init;
this port counts them from the shapes ``repro/models/transformer.py`` (and
``layers.py``, ``attention.py``) initialize.  The other families (MoE,
Mamba2, hybrid, VLM, audio) arrive with the model zoo in slice 7 of the
port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config fields that the dense family's memory program
    and parameter count read (the MoE / SSM / hybrid fields arrive with
    those families)."""

    name: str
    family: str  # 'dense' here; 'moe' | 'hybrid' | 'ssm' | 'vlm' | 'audio' in slice 7
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
    tie_embeddings: bool = True
    embed_inputs: bool = True  # False: step takes precomputed embeddings
    norm: str = "rms"  # 'rms' | 'ln'
    mlp_gated: bool = True  # False: plain 2-matrix GELU MLP
    pad_vocab_to_multiple: int = 0

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
        """((mixer, ffn), ...) for one group: one attention + MLP layer."""
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r} comes with the model zoo (slice 7 of "
                "the port); only 'dense' is described"
            )
        return (("attn", "mlp"),)

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

    # ------------------------------------------------------------------ #
    # parameter accounting (analytic, from the reference's init shapes)
    # ------------------------------------------------------------------ #

    def param_counts(self) -> Dict[str, float]:
        """``{'total', 'active', 'expert'}`` parameter counts.

        The sum of every leaf the reference's ``Model.init`` creates for
        the dense family — embedding, per-layer norms, attention projections
        (and q/k norms), the MLP, the final norm and an untied head.  Equal
        to the reference's ``eval_shape`` count exactly.
        """
        d, hd = self.d_model, self.d_head
        norm = 2 * d if self.norm == "ln" else d  # ln: gain + bias
        attn = (
            d * self.n_heads * hd  # wq
            + 2 * d * self.n_kv_heads * hd  # wk, wv
            + self.n_heads * hd * d  # wo
            + (2 * hd if self.qk_norm else 0)  # q_norm, k_norm
        )
        gated = self.norm != "ln" and self.mlp_gated
        mlp = (3 if gated else 2) * d * self.d_ff  # wi (+ wu) + wo
        layer = norm + attn + norm + mlp
        total = self.n_groups * self.group_size * layer + norm  # + final norm
        if self.embed_inputs:
            total += self.padded_vocab * d
        if not self.tie_embeddings or not self.embed_inputs:
            total += d * self.padded_vocab  # lm_head
        return {"total": float(total), "active": float(total), "expert": 0.0}
