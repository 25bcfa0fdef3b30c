"""Model configuration without JAX: the fields the model, the memory-program
synthesis and the analytic parameter counts read.

Port of ``repro/models/model.py:ModelConfig`` for every family of the model
zoo (dense, moe, hybrid, ssm, vlm, audio).  The reference counts parameters
by ``jax.eval_shape`` over the model's init; this port counts them from the
shapes ``repro/models/transformer.py`` (and ``layers.py``, ``attention.py``,
``mamba2.py``, ``moe.py``) initialize.

The reference's TPU- and XLA-only fields stay out: ``cast_params_at_step``
and ``fsdp_gather_at_layer`` (where the parameter all-gather casts under
FSDP sharding) and ``scan_layers`` (a ``lax.scan`` over stacked groups; the
port loops over an ``nn.ModuleList``).  None of them changes a parameter
count or a memory program.  ``remat`` and ``remat_policy_name`` are the
reference's: with ``remat`` the training forward keeps only each group's
input and recomputes the group in the backward pass
(``torch.utils.checkpoint``, as ``jax.checkpoint`` around the reference's
scan body), which is what lets an 8 x 4096-token qwen3-0.6b step fit on one
card; ``remat_policy_name="dots"`` also keeps the group's weight products,
as the reference's ``dots_with_no_batch_dims_saveable``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["ModelConfig"]

CONV_K = 4  # Mamba2's depthwise causal conv width (repro/models/mamba2.py)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config fields, but the TPU- and XLA-only ones (see
    the module docstring)."""

    name: str
    family: str  # 'dense' | 'moe' | 'hybrid' | 'ssm' | 'vlm' | 'audio'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 => d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # expert hidden (granite: 512); 0 => d_ff
    moe_interleave: int = 1  # MoE every k-th layer
    shared_expert: bool = False
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 2.0
    moe_dispatch: str = "einsum"  # 'einsum' | 'scatter' | 'dense' (models/moe.py)
    moe_group_tokens: int = 4096  # GShard dispatch group size
    # --- attention ---
    rope_variant: str = "rope"  # 'rope' | 'rope2d' | 'mrope' | 'none'
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None  # sliding-window span (attention layers)
    attn_block_q: int = 1024  # chunked_attention's query block
    attn_block_k: int = 1024  # chunked_attention's key block
    # --- SSM (Mamba2) / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_head: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0  # hybrid: 1 attn sublayer per group of this size
    # --- embeddings / misc ---
    tie_embeddings: bool = True
    embed_inputs: bool = True  # False: step takes precomputed embeddings
    norm: str = "rms"  # 'rms' | 'ln'
    mlp_gated: bool = True  # False: plain 2-matrix GELU MLP
    pad_vocab_to_multiple: int = 0
    dtype: torch.dtype = torch.bfloat16  # activations
    cache_dtype: torch.dtype = torch.bfloat16  # KV caches (the SSM caches stay f32)
    remat: bool = True  # recompute each group in the backward pass
    remat_policy_name: str = "nothing"  # 'nothing' (save nothing) | 'dots' (keep weight products)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        if self.family in ("moe",) and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.remat_policy_name not in ("nothing", "dots"):
            raise ValueError(f"unknown remat policy {self.remat_policy_name!r}")

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to_multiple
        if m and self.vocab_size % m:
            return self.vocab_size + (m - self.vocab_size % m)
        return self.vocab_size

    def group_spec(self) -> Tuple[Tuple[str, Optional[str]], ...]:
        """((mixer, ffn), ...) for one group: attention + MLP (dense, vlm,
        audio); ``moe_interleave - 1`` of those then attention + MoE (moe);
        one Mamba2 layer with an MLP only when ``d_ff > 0`` (ssm); or
        ``attn_every`` sublayers with attention mid-group, Mamba2 elsewhere,
        and MoE feed-forwards on odd positions when there are experts
        (hybrid)."""
        fam = self.family
        if fam in ("dense", "vlm", "audio"):
            return (("attn", "mlp"),)
        if fam == "moe":
            k = max(self.moe_interleave, 1)
            return tuple(
                ("attn", "moe" if i == k - 1 else "mlp") for i in range(k)
            )
        if fam == "ssm":
            return (("mamba", None if self.d_ff == 0 else "mlp"),)
        if fam == "hybrid":
            k = self.attn_every
            attn_pos = k // 2  # attention mid-group (Jamba places it interior)
            spec = []
            for i in range(k):
                mixer = "attn" if i == attn_pos else "mamba"
                ffn = "moe" if (self.n_experts and i % 2 == 1) else "mlp"
                spec.append((mixer, ffn))
            return tuple(spec)
        raise ValueError(f"unknown family {fam}")

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
        ``dt_bias``, ``D``, ``norm`` and ``out_proj``), the feed-forward
        (the MLP, or the MoE's router, stacked experts ``wi``/``wu``/``wo``
        and optional shared expert), the final norm and an untied head.
        ``expert`` counts the stacked experts (the reference's leaves named
        ``wi``/``wu``/``wo`` under ``moe``), and ``active`` takes away the
        experts a token does not visit, in the reference's float expression.
        Equal to the reference's ``eval_shape`` count exactly.
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
        group_expert = 0
        for mix, ffn in self.group_spec():
            group += norm + mixer[mix]
            if ffn == "mlp":
                group += norm + (3 if gated else 2) * d * self.d_ff  # wi (+ wu) + wo
            elif ffn == "moe":
                e, f = self.n_experts, self.moe_d_ff or self.d_ff
                experts = 3 * e * d * f  # stacked wi, wu [E, d, f] + wo [E, f, d]
                group += norm + d * e + experts  # + router [d, E]
                if self.shared_expert:
                    group += 3 * d * f  # shared_wi, shared_wu, shared_wo
                group_expert += experts
        total = self.n_groups * group + norm  # + final norm
        if self.embed_inputs:
            total += self.padded_vocab * d
        if not self.tie_embeddings or not self.embed_inputs:
            total += d * self.padded_vocab  # lm_head
        expert = self.n_groups * group_expert
        active = total
        if self.n_experts and self.top_k:
            active = total - expert * (1.0 - self.top_k / self.n_experts)
        return {"total": float(total), "active": float(active), "expert": float(expert)}

    def model_flops(self, kind: str, batch: int, seq: int) -> float:
        """The reference's model FLOPs: 6·N_active·tokens (train),
        2·N_active·tokens (prefill), 2·N_active·batch (decode, one token a
        sequence)."""
        n = self.param_counts()["active"]
        if kind == "train":
            return 6.0 * n * batch * seq
        if kind == "prefill":
            return 2.0 * n * batch * seq
        if kind == "decode":
            return 2.0 * n * batch
        raise ValueError(kind)

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
