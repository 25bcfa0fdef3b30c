"""Block assembly: per-family layer groups and the stack over them (port of
``repro/models/transformer.py`` for the ssm family).

A model is a stack of identical **groups** (``cfg.group_spec()``); the
reference scans over stacked group parameters, the port loops over an
``nn.ModuleList`` of groups (scan and remat are XLA devices with no role in
serving).  Caches keep the reference's stacked decode format:

  {'ssm_conv': [G, n_mamba, B, K-1, di], 'ssm_state': [G, n_mamba, B, H, N, P]}

Attention mixers arrive with the attention families' cut of slice 7, MoE
and MLP feed-forwards with theirs; they raise here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from . import mamba2 as m2
from .layers import rms_norm

__all__ = ["Group", "apply_group", "apply_stack", "decode_group", "decode_stack"]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} comes with a later cut of the model zoo (slice 7 of the port: the "
        "attention families, then MoE); the ssm family's Mamba2 groups are ported"
    )


class Group(nn.Module):
    """Parameters of ONE group, named as the reference's tree:
    ``sub{i}.norm1`` and ``sub{i}.mamba.{in_proj, conv_w, ...}``."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        if cfg.norm != "rms":
            raise _unported(f"norm {cfg.norm!r}")
        for i, (mixer, ffn) in enumerate(cfg.group_spec()):
            if mixer != "mamba":
                raise _unported(f"the {mixer!r} mixer")
            if ffn is not None:
                raise _unported(f"the {ffn!r} feed-forward")
            sub = nn.Module()
            sub.norm1 = nn.Parameter(torch.ones(cfg.d_model, device=gen.device))
            sub.mamba = nn.ParameterDict(
                m2.init_mamba2(gen, cfg.d_model, cfg.ssm_heads, cfg.ssm_d_head, cfg.ssm_state)
            )
            self.add_module(f"sub{i}", sub)


def apply_group(
    p: Group,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,
    cfg,
    collect_cache: bool = False,
    cache_pad_to: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (x, aux_loss, group_cache) for one group; ``group_cache``
    (prefill only) is already in decode format.  ``positions`` and
    ``cache_pad_to`` only matter to attention sublayers."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ssm_conv: List[torch.Tensor] = []
    ssm_state: List[torch.Tensor] = []
    for i, _ in enumerate(cfg.group_spec()):
        sub = getattr(p, f"sub{i}")
        h = rms_norm(x, sub.norm1)
        args = (sub.mamba, h, cfg.ssm_heads, cfg.ssm_d_head, cfg.ssm_state)
        if collect_cache:
            mix, mcache = m2.mamba2_prefill(*args, chunk=cfg.ssm_chunk)
            ssm_conv.append(mcache["conv"])
            ssm_state.append(mcache["ssm"])
        else:
            mix = m2.mamba2_block(*args, chunk=cfg.ssm_chunk)
        x = x + mix
    cache = None
    if collect_cache:
        cache = {"ssm_conv": torch.stack(ssm_conv), "ssm_state": torch.stack(ssm_state)}
    return x, aux, cache


def decode_group(
    p: Group,
    x: torch.Tensor,  # [B, 1, D]
    positions: torch.Tensor,
    cache: Dict[str, Any],  # this group's cache slice
    cache_len,
    cfg,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    conv: List[torch.Tensor] = []
    state: List[torch.Tensor] = []
    for i, _ in enumerate(cfg.group_spec()):
        sub = getattr(p, f"sub{i}")
        h = rms_norm(x, sub.norm1)
        mc = {"conv": cache["ssm_conv"][i], "ssm": cache["ssm_state"][i]}
        mix, mc_new = m2.mamba2_decode(
            sub.mamba, h, mc, cfg.ssm_heads, cfg.ssm_d_head, cfg.ssm_state
        )
        conv.append(mc_new["conv"])
        state.append(mc_new["ssm"])
        x = x + mix
    return x, {"ssm_conv": torch.stack(conv), "ssm_state": torch.stack(state)}


def apply_stack(
    stack: nn.ModuleList,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    collect_cache: bool = False,
    cache_pad_to: Optional[int] = None,
):
    """Loop over the groups.  Returns (x, aux, stacked_caches)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for gp in stack:
        x, a, cache = apply_group(
            gp, x, positions, cfg, collect_cache=collect_cache, cache_pad_to=cache_pad_to
        )
        aux = aux + a
        caches.append(cache)
    stacked = None
    if collect_cache:
        stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    return x, aux, stacked


def decode_stack(stack: nn.ModuleList, x, positions, caches, cache_len, cfg):
    """Decode over the groups with per-group cache slices; returns (x, new
    stacked caches)."""
    new = []
    for g, gp in enumerate(stack):
        x, nc = decode_group(gp, x, positions, {k: v[g] for k, v in caches.items()},
                             cache_len, cfg)
        new.append(nc)
    return x, {k: torch.stack([c[k] for c in new]) for k in new[0]}
