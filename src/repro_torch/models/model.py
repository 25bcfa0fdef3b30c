"""The model: init, forward, prefill and decode (port of
``repro/models/model.py:Model`` for the dense and ssm families; ``loss``
waits for the training slice).

:class:`Model` is an ``nn.Module`` whose parameters carry the reference's
names and layouts (``embed [V, D]``, ``blocks.{g}.sub0.attn.wq [D, H·Dh]``
or ``blocks.{g}.sub0.mamba.in_proj [D, out]``, ``final_norm [D]``), f32, on
the device it was built on; compute runs in ``cfg.dtype`` (bf16) with
weights cast at use, as in the reference.  Built with ``device="cuda"``
(the default) it raises without a card; the tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.analyzer import _check_device
from . import transformer as tf
from .config import CONV_K, ModelConfig
from .layers import rms_norm

__all__ = ["Model"]


class Model(nn.Module):
    """Weights of one config, drawn from ``torch.Generator`` ``seed`` with
    the reference's initial distributions, and its step functions."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family not in ("dense", "ssm"):
            # the config describes the family's structure (group_spec,
            # param_counts, memory programs); its forward pass is not here
            raise tf._unported(f"the {cfg.family!r} family's forward pass")
        dev = _check_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        if cfg.embed_inputs:
            self.embed = nn.Parameter(
                torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, device=dev) * 0.02
            )
        self.blocks = nn.ModuleList(tf.Group(cfg, gen) for _ in range(cfg.n_groups))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        if not cfg.tie_embeddings or not cfg.embed_inputs:
            self.lm_head = nn.Parameter(
                torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen, device=dev) * 0.02
            )
        self.requires_grad_(False)  # serving only: training comes with its slice

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ---- shared forward ------------------------------------------------- #

    def _positions(self, batch: int, seq: int, offset: int = 0) -> torch.Tensor:
        if self.cfg.rope_variant not in ("rope", "none"):
            raise tf._unported(f"rope variant {self.cfg.rope_variant!r}")
        pos = torch.arange(seq, dtype=torch.int32, device=self.device)[None, :] + offset
        return pos.expand(batch, seq)

    def _embed(self, tokens_or_embeds: torch.Tensor) -> torch.Tensor:
        if self.cfg.embed_inputs:
            return self.embed[tokens_or_embeds].to(self.cfg.dtype)
        return tokens_or_embeds.to(self.cfg.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        xn = rms_norm(x, self.final_norm)
        w = self.lm_head if hasattr(self, "lm_head") else self.embed.t()
        logits = xn @ w.to(cfg.dtype)  # [B, S, V_padded]
        if cfg.padded_vocab != cfg.vocab_size:
            # mask pad columns: argmax and softmax identical to unpadded
            col = torch.arange(cfg.padded_vocab, device=x.device)
            logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
        return logits

    def forward(self, tokens_or_embeds, positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits ``[B, S, V]`` and the auxiliary loss."""
        x = self._embed(tokens_or_embeds)
        B, S = x.shape[:2]
        if positions is None:
            positions = self._positions(B, S)
        x, aux, _ = tf.apply_stack(self.blocks, x, positions, self.cfg)
        return self._head(x), aux

    # ---- serving --------------------------------------------------------- #

    def prefill(self, tokens_or_embeds, pad_to: Optional[int] = None):
        """Returns (last_logits [B, V], caches, cache_len)."""
        x = self._embed(tokens_or_embeds)
        B, S = x.shape[:2]
        x, _, caches = tf.apply_stack(
            self.blocks, x, self._positions(B, S), self.cfg,
            collect_cache=True, cache_pad_to=pad_to or S,
        )
        logits = self._head(x[:, -1:, :])[:, 0]
        return logits, caches, S

    def init_caches(self, batch: int, s_max: int) -> Dict[str, Any]:
        """Zero caches for decode from scratch (``s_max`` sizes the KV
        caches)."""
        cfg = self.cfg
        cache: Dict[str, Any] = {}
        na, nm, G = cfg.attn_layers_per_group, cfg.mamba_layers_per_group, cfg.n_groups
        if na:
            shape = (G, na, batch, cfg.n_kv_heads, s_max, cfg.d_head)
            cache["kv"] = {
                "k": torch.zeros(shape, dtype=cfg.cache_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.cache_dtype, device=self.device),
            }
        if nm:
            di = cfg.ssm_heads * cfg.ssm_d_head
            f32 = torch.float32
            cache["ssm_conv"] = torch.zeros((G, nm, batch, CONV_K - 1, di), dtype=f32,
                                            device=self.device)
            cache["ssm_state"] = torch.zeros(
                (G, nm, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_d_head), dtype=f32,
                device=self.device,
            )
        return cache

    def decode_step(self, caches, token_or_embed, cache_len: int):
        """One token for every sequence; returns (logits [B, V], new_caches).
        The token's K/V go into ``caches['kv']`` in place (slot
        ``cache_len``), and ``new_caches['kv']`` is that same pair."""
        x = self._embed(token_or_embed)  # [B, 1, D]
        positions = self._positions(x.shape[0], 1, offset=cache_len)
        x, new_caches = tf.decode_stack(self.blocks, x, positions, caches, cache_len, self.cfg)
        return self._head(x)[:, 0], new_caches
