"""The model: init, forward, the training loss, prefill and decode (port
of ``repro/models/model.py:Model`` for every family: dense, moe, hybrid,
ssm, vlm and audio).

:class:`Model` is an ``nn.Module`` whose parameters carry the reference's
names and layouts (``embed [V, D]``, ``blocks.{g}.sub0.attn.wq [D, H·Dh]``
or ``blocks.{g}.sub0.mamba.in_proj [D, out]``, ``final_norm [D]`` or
``final_norm.{g, b}`` under LayerNorm, ``lm_head [D, V]``), f32, on the
device it was built on; compute runs in ``cfg.dtype`` (bf16) with weights
cast at use, as in the reference.  Built with ``device="cuda"`` (the
default) it raises without a card; the tests pass ``device="cpu"``.

With ``embed_inputs=False`` (qwen2-vl, hubert) the model has no embedding
table: its steps take ``[B, S, d_model]`` embeddings, and the head is the
untied ``lm_head``.  Positions are ``[B, S]``, or ``[B, 2, S]`` under
``rope2d`` (stream 1 all zeros) and ``[B, 3, S]`` under ``mrope`` (the
text stub: every stream the token's position).  An ``audio`` model is an
encoder (``causal=False``; ``configs.cells`` runs no decode for it), but
:meth:`Model.decode_step` runs for it as the reference's does.

A model is built with its parameters' gradients off, as serving wants;
a train step (:func:`repro_torch.launch.steps.make_train_step`) turns them
on.  The serving entries (:meth:`Model.prefill`, :meth:`Model.decode_step`)
always run under ``torch.inference_mode()``, so serving a trained model
builds no autograd graph.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.analyzer import _check_device
from . import transformer as tf
from .config import CONV_K, ModelConfig

__all__ = ["HEAD_CHUNK_TOKENS", "Model"]

# Tokens per chunk of the training head in Model.loss: the f32 logits of
# one chunk, [4096, V], and their log-softmax live at a time (2.5 GB each
# at qwen3-0.6b's 151936 words), never the whole batch's [B, S, V].  The
# chunked loss is the reference's function; only the order of its f32 sum
# over tokens differs (a sum per chunk, then over chunks): within rel 1e-6
# of the unchunked form on the tests' configs (tests/test_torch_train.py).
HEAD_CHUNK_TOKENS = 4096


class Model(nn.Module):
    """Weights of one config, drawn from ``torch.Generator`` ``seed`` with
    the reference's initial distributions, and its step functions.
    ``device="meta"`` builds the parameters' shapes and dtypes only,
    allocating nothing (:func:`repro_torch.launch.steps.abstract_train_state`)."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.rope_variant not in ("rope", "rope2d", "mrope", "none"):
            raise ValueError(f"unknown rope variant {cfg.rope_variant!r}")
        dev = torch.device(device)
        if dev.type != "meta":
            dev = _check_device(dev)
        self.cfg = cfg
        # a meta model draws nothing; its generator only has to exist
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
        if cfg.embed_inputs:
            self.embed = nn.Parameter(
                torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, device=dev) * 0.02
            )
        self.blocks = nn.ModuleList(tf.Group(cfg, gen, dev) for _ in range(cfg.n_groups))
        self.final_norm = tf.init_norm(cfg, dev)
        if not cfg.tie_embeddings or not cfg.embed_inputs:
            self.lm_head = nn.Parameter(
                torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen, device=dev) * 0.02
            )
        self.requires_grad_(False)  # serving; a train step turns gradients on

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ---- shared forward ------------------------------------------------- #

    def _positions(self, batch: int, seq: int, offset: int = 0) -> torch.Tensor:
        """``[B, S]`` positions from ``offset``; ``[B, 2, S]`` under rope2d
        (stream 1 zeros) and ``[B, 3, S]`` under mrope (every stream the
        position), the offset applied before the streams are stacked."""
        pos = torch.arange(seq, dtype=torch.int32, device=self.device)[None, :] + offset
        pos = pos.expand(batch, seq)
        if self.cfg.rope_variant == "rope2d":
            return torch.stack([pos, torch.zeros_like(pos)], dim=1)
        if self.cfg.rope_variant == "mrope":
            return torch.stack([pos, pos, pos], dim=1)  # the text stub
        return pos

    def _embed(self, tokens_or_embeds: torch.Tensor) -> torch.Tensor:
        if self.cfg.embed_inputs:
            return self.embed[tokens_or_embeds].to(self.cfg.dtype)
        return tokens_or_embeds.to(self.cfg.dtype)

    def _head_weight(self) -> torch.Tensor:
        """The output projection ``[D, V_padded]`` in ``cfg.dtype``: the
        untied head, or the embedding transposed."""
        w = self.lm_head if hasattr(self, "lm_head") else self.embed.t()
        return w.to(self.cfg.dtype)

    def _logits(self, xn: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Normed activations ``[..., D]`` to logits ``[..., V_padded]``."""
        cfg = self.cfg
        logits = xn @ w
        if cfg.padded_vocab != cfg.vocab_size:
            # mask pad columns: argmax and softmax identical to unpadded
            col = torch.arange(cfg.padded_vocab, device=xn.device)
            logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
        return logits

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self._logits(tf.norm(self.cfg, x, self.final_norm), self._head_weight())

    def forward(self, tokens_or_embeds, positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits ``[B, S, V]`` and the auxiliary loss."""
        x = self._embed(tokens_or_embeds)
        B, S = x.shape[:2]
        if positions is None:
            positions = self._positions(B, S)
        x, aux, _ = tf.apply_stack(self.blocks, x, positions, self.cfg)
        return self._head(x), aux

    # ---- training loss --------------------------------------------------- #

    def _chunk_ll(self, xn: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
        """The summed log-likelihood of one chunk's valid labels, f32."""
        logp = torch.log_softmax(self._logits(xn, w).float(), dim=-1)
        valid = labels >= 0
        safe = torch.where(valid, labels, 0)
        ll = logp.gather(-1, safe[:, None])[:, 0]
        return (ll * valid).sum()

    def loss(self, batch, aux_weight: float = 0.01):
        """``batch``: ``tokens`` (or ``embeds``) and ``labels [B, S]`` (-1 =
        masked), optionally ``positions``, on the model's device.  Returns
        ``(loss, {'ce', 'aux'})``: the f32 log-softmax cross-entropy over the
        valid labels, divided by ``max(n_valid, 1)``, plus ``aux_weight *
        aux``, the reference's ``Model.loss``.

        The head and the cross-entropy run over chunks of
        ``HEAD_CHUNK_TOKENS`` tokens, each under activation recomputation
        when autograd records: a chunk's logits exist only while that chunk
        is computed, in the forward and again in the backward pass."""
        cfg = self.cfg
        inp = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
        x = self._embed(inp)
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = self._positions(B, S)
        x, aux, _ = tf.apply_stack(self.blocks, x, positions, cfg)
        xn = tf.norm(cfg, x, self.final_norm).reshape(B * S, -1)
        labels = batch["labels"].reshape(B * S).long()
        w = self._head_weight()
        ll = torch.zeros((), dtype=torch.float32, device=xn.device)
        for i in range(0, B * S, HEAD_CHUNK_TOKENS):
            part = (xn[i:i + HEAD_CHUNK_TOKENS], w, labels[i:i + HEAD_CHUNK_TOKENS])
            if torch.is_grad_enabled():
                # no randomness in the head: nothing to save of the RNG
                ll = ll + checkpoint(self._chunk_ll, *part, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                ll = ll + self._chunk_ll(*part)
        n = (labels >= 0).sum().clamp(min=1)
        ce = -ll / n
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    # ---- serving --------------------------------------------------------- #

    @torch.inference_mode()
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

    @torch.inference_mode()
    def decode_step(self, caches, token_or_embed, cache_len: int):
        """One token for every sequence; returns (logits [B, V], new_caches).
        The token's K/V go into ``caches['kv']`` in place (slot
        ``cache_len``), and ``new_caches['kv']`` is that same pair."""
        x = self._embed(token_or_embed)  # [B, 1, D]
        positions = self._positions(x.shape[0], 1, offset=cache_len)
        x, new_caches = tf.decode_stack(self.blocks, x, positions, caches, cache_len, self.cfg)
        return self._head(x)[:, 0], new_caches
