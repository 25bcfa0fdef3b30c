"""Block assembly: per-family layer groups and the stack over them (port of
``repro/models/transformer.py`` for every family: dense, moe, hybrid, ssm,
vlm and audio).

A model is a stack of identical **groups** (``cfg.group_spec()``); the
reference scans over stacked group parameters, the port loops over an
``nn.ModuleList`` of groups.  With ``cfg.remat`` a training forward runs
each group under activation recomputation, as the reference's
``jax.checkpoint`` around its scan body (under ``remat_policy_name="dots"``
keeping the groups' weight products, as ``dots_with_no_batch_dims_saveable``
does).  A sublayer is a mixer (GQA attention, causal or not, or Mamba2) and
an optional feed-forward: a gated MLP, the plain GELU MLP (under
``norm="ln"`` or ``mlp_gated=False``), or a MoE layer
(:mod:`repro_torch.models.moe`), whose auxiliary loss the group sums.
Norms are RMS norms, or layer norms with a ``{g, b}`` pair under
``norm="ln"``.  Caches keep the reference's stacked decode format:

  {'kv': {'k': [G, n_attn, B, Hk, Smax, D], 'v': ...},
   'ssm_conv': [G, n_mamba, B, K-1, di], 'ssm_state': [G, n_mamba, B, H, N, P]}

Decode writes each token's K/V into ``kv`` in place and returns the same
tensors; the Mamba2 caches are restacked, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from . import attention as attn
from . import mamba2 as m2
from . import moe as moe_mod
from .layers import dense_mlp, gated_mlp, init_dense_mlp, init_gated_mlp, layer_norm, rms_norm

__all__ = ["Group", "apply_group", "apply_stack", "decode_group", "decode_stack", "init_norm",
           "norm"]


def init_norm(cfg, device) -> nn.Module:
    """A norm's parameters: the RMS gain ``[D]``, or the layer norm's ``{g,
    b}`` pair under ``norm="ln"``."""
    if cfg.norm == "ln":
        return nn.ParameterDict({"g": torch.ones(cfg.d_model, device=device),
                                 "b": torch.zeros(cfg.d_model, device=device)})
    return nn.Parameter(torch.ones(cfg.d_model, device=device))


def norm(cfg, x: torch.Tensor, p) -> torch.Tensor:
    """``cfg``'s norm of ``x`` with the parameters ``p`` of :func:`init_norm`."""
    if cfg.norm == "ln":
        return layer_norm(x, p["g"], p["b"])
    return rms_norm(x, p)


def _dense(cfg) -> bool:
    """The plain GELU MLP, not the gated one (the reference's rule)."""
    return cfg.norm == "ln" or not cfg.mlp_gated


class Group(nn.Module):
    """Parameters of ONE group, named as the reference's tree:
    ``sub{i}.norm1`` (or ``sub{i}.norm1.{g, b}``),
    ``sub{i}.attn.{wq, wk, wv, wo, q_norm, k_norm}`` or
    ``sub{i}.mamba.{in_proj, conv_w, ...}``, and ``sub{i}.norm2``,
    ``sub{i}.mlp.{wi, wu, wo}`` (``{wi, wo}`` for the GELU MLP) or
    ``sub{i}.moe.{router, wi, wu, wo}`` (and ``shared_wi``, ``shared_wu``,
    ``shared_wo``)."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        dev = device or gen.device
        if cfg.norm not in ("rms", "ln"):
            raise ValueError(f"unknown norm {cfg.norm!r}")
        for i, (mixer, ffn) in enumerate(cfg.group_spec()):
            sub = nn.Module()
            sub.norm1 = init_norm(cfg, dev)
            if mixer == "attn":
                sub.attn = nn.ParameterDict(attn.init_attention(
                    gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.qk_norm,
                    device=dev))
            elif mixer == "mamba":
                sub.mamba = nn.ParameterDict(m2.init_mamba2(
                    gen, cfg.d_model, cfg.ssm_heads, cfg.ssm_d_head, cfg.ssm_state, device=dev))
            else:
                raise ValueError(mixer)
            if ffn is not None:
                sub.norm2 = init_norm(cfg, dev)
                if ffn == "mlp":
                    init = init_dense_mlp if _dense(cfg) else init_gated_mlp
                    sub.mlp = nn.ParameterDict(init(gen, cfg.d_model, cfg.d_ff, dev))
                else:
                    sub.moe = nn.ParameterDict(moe_mod.init_moe(
                        gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                        shared_expert=cfg.shared_expert, device=dev))
            self.add_module(f"sub{i}", sub)


def _feed_forward(sub, ffn: str, h: torch.Tensor, cfg, capacity_factor: float):
    """A sublayer's feed-forward on its normed input: (output, the MoE's
    aux loss or None)."""
    if ffn == "moe":
        return moe_mod.moe_block(sub.moe, h, cfg.top_k, capacity_factor=capacity_factor,
                                 dispatch=cfg.moe_dispatch, group_tokens=cfg.moe_group_tokens)
    return (dense_mlp if _dense(cfg) else gated_mlp)(sub.mlp, h), None


def apply_group(
    p: Group,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S], or [B, n_streams, S] (rope2d, mrope)
    cfg,
    collect_cache: bool = False,
    cache_pad_to: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (x, aux_loss, group_cache) for one group; ``group_cache``
    (prefill only) is already in decode format, with K/V padded on the
    sequence axis to ``cache_pad_to`` (the decode budget) and cast to
    ``cfg.cache_dtype``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv_k: List[torch.Tensor] = []
    kv_v: List[torch.Tensor] = []
    ssm_conv: List[torch.Tensor] = []
    ssm_state: List[torch.Tensor] = []
    for i, (mixer, ffn) in enumerate(cfg.group_spec()):
        sub = getattr(p, f"sub{i}")
        h = norm(cfg, x, sub.norm1)
        if mixer == "attn" and collect_cache:
            # prefill: also keep this sublayer's K/V for the cache
            B, S, _ = h.shape
            q, k, v = attn._project_qkv(sub.attn, h, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                        positions, cfg.rope_variant, cfg.qk_norm, cfg.rope_theta)
            o = attn.chunked_attention(q, k, v, causal=cfg.causal, block_q=cfg.attn_block_q,
                                       block_k=cfg.attn_block_k, window=cfg.window)
            mix = o.transpose(1, 2).reshape(B, S, -1) @ sub.attn["wo"].to(h.dtype)
            pad = (cache_pad_to or S) - S
            if pad > 0:
                k = torch.nn.functional.pad(k, (0, 0, 0, pad))
                v = torch.nn.functional.pad(v, (0, 0, 0, pad))
            kv_k.append(k.to(cfg.cache_dtype))
            kv_v.append(v.to(cfg.cache_dtype))
        elif mixer == "attn":
            mix = attn.attention_block(
                sub.attn, h, positions, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                causal=cfg.causal, rope_variant=cfg.rope_variant, qk_norm=cfg.qk_norm,
                theta=cfg.rope_theta, window=cfg.window, block_q=cfg.attn_block_q,
                block_k=cfg.attn_block_k,
            )
        else:
            args = (sub.mamba, h, cfg.ssm_heads, cfg.ssm_d_head, cfg.ssm_state)
            if collect_cache:
                mix, mcache = m2.mamba2_prefill(*args, chunk=cfg.ssm_chunk)
                ssm_conv.append(mcache["conv"])
                ssm_state.append(mcache["ssm"])
            else:
                mix = m2.mamba2_block(*args, chunk=cfg.ssm_chunk)
        x = x + mix
        if ffn is not None:
            out, a = _feed_forward(sub, ffn, norm(cfg, x, sub.norm2), cfg, cfg.capacity_factor)
            x = x + out
            if a is not None:
                aux = aux + a
    cache = None
    if collect_cache:
        cache = {}
        if kv_k:
            cache["kv"] = {"k": torch.stack(kv_k), "v": torch.stack(kv_v)}
        if ssm_conv:
            cache["ssm_conv"] = torch.stack(ssm_conv)
            cache["ssm_state"] = torch.stack(ssm_state)
    return x, aux, cache


def decode_group(
    p: Group,
    x: torch.Tensor,  # [B, 1, D]
    positions: torch.Tensor,
    cache: Dict[str, Any],  # this group's cache slice
    cache_len: int,
    cfg,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token through one group.  Returns (x, the group's new Mamba2
    caches); its KV slices are updated in place."""
    conv: List[torch.Tensor] = []
    state: List[torch.Tensor] = []
    ai = mi = 0
    for i, (mixer, ffn) in enumerate(cfg.group_spec()):
        sub = getattr(p, f"sub{i}")
        h = norm(cfg, x, sub.norm1)
        if mixer == "attn":
            kv = (cache["kv"]["k"][ai], cache["kv"]["v"][ai])
            mix, _ = attn.decode_attention_block(
                sub.attn, h, positions, kv, cache_len, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_head, rope_variant=cfg.rope_variant, qk_norm=cfg.qk_norm,
                theta=cfg.rope_theta, window=cfg.window,
            )
            ai += 1
        else:
            mc = {"conv": cache["ssm_conv"][mi], "ssm": cache["ssm_state"][mi]}
            mix, mc_new = m2.mamba2_decode(
                sub.mamba, h, mc, cfg.ssm_heads, cfg.ssm_d_head, cfg.ssm_state
            )
            conv.append(mc_new["conv"])
            state.append(mc_new["ssm"])
            mi += 1
        x = x + mix
        if ffn is not None:
            # decode's own capacity; the aux loss is a training term
            x = x + _feed_forward(sub, ffn, norm(cfg, x, sub.norm2), cfg,
                                  cfg.decode_capacity_factor)[0]
    new = {"ssm_conv": torch.stack(conv), "ssm_state": torch.stack(state)} if conv else {}
    return x, new


def _stack(caches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-group caches stacked on a leading group axis."""
    out: Dict[str, Any] = {}
    for k, v in caches[0].items():
        if isinstance(v, dict):
            out[k] = {kk: torch.stack([c[k][kk] for c in caches]) for kk in v}
        else:
            out[k] = torch.stack([c[k] for c in caches])
    return out


# the weight products: ``x @ W`` with a 2-D weight lowers to ``aten.mm`` on
# a view of ``x`` (``aten.addmm`` with a bias), a product with no batch
# dimension; the attention's products are ``aten.bmm`` (batch dimensions)
_NO_BATCH_DIMS_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dimensions, recompute the rest."""
    if op in _NO_BATCH_DIMS_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def apply_stack(
    stack: nn.ModuleList,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    collect_cache: bool = False,
    cache_pad_to: Optional[int] = None,
):
    """Loop over the groups.  Returns (x, aux, stacked_caches).

    When autograd records (grad enabled, a training forward) and
    ``cfg.remat`` is set, each group runs under
    ``torch.utils.checkpoint``: under ``remat_policy_name="nothing"`` only
    its input is kept, and the backward pass runs the group again; under
    ``"dots"`` the outputs of its weight products (``aten.mm`` and
    ``aten.addmm``) are kept too, and the rest (the attention's ``bmm``,
    norms, activations) is recomputed.  Nothing in the forward pass draws
    random numbers (no dropout), so the recomputation is exact without
    saving and restoring the RNG state (``preserve_rng_state=False``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    kw = dict(context_fn=_dots_contexts) if cfg.remat_policy_name == "dots" else {}
    for gp in stack:
        if remat:
            x, a, cache = checkpoint(apply_group, gp, x, positions, cfg,
                                     use_reentrant=False, preserve_rng_state=False, **kw)
        else:
            x, a, cache = apply_group(
                gp, x, positions, cfg, collect_cache=collect_cache, cache_pad_to=cache_pad_to
            )
        aux = aux + a
        caches.append(cache)
    return x, aux, _stack(caches) if collect_cache else None


def decode_stack(stack: nn.ModuleList, x, positions, caches, cache_len: int, cfg):
    """Decode over the groups with per-group cache slices; returns (x, new
    stacked caches): the KV caches are the given tensors, updated in place."""
    new = []
    for g, gp in enumerate(stack):
        group_cache = {k: ({kk: vv[g] for kk, vv in v.items()} if isinstance(v, dict) else v[g])
                       for k, v in caches.items()}
        x, nc = decode_group(gp, x, positions, group_cache, cache_len, cfg)
        new.append(nc)
    out = _stack(new) if new[0] else {}
    if "kv" in caches:
        out["kv"] = caches["kv"]
    return x, out
