"""Serving step builders (port of ``repro/launch/steps.py``:
``make_prefill_step`` and ``make_decode_step``; ``make_train_step`` waits
for the training slice).

As in the reference, a step takes the parameters explicitly: here the
:class:`~repro_torch.models.model.Model` that holds them (built on the card
by default), then the batch or the decode state.  Steps run under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.model import Model

__all__ = ["make_decode_step", "make_prefill_step"]


def _check(cfg: ModelConfig, params: Model) -> None:
    if params.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is {params.cfg.name}")


def make_prefill_step(cfg: ModelConfig, pad_to: Optional[int] = None):
    """``prefill_step(params, batch) -> (last_logits [B, V], caches,
    cache_len)``; ``batch`` holds ``tokens`` (or ``embeds``)."""

    def prefill_step(params: Model, batch):
        _check(cfg, params)
        inp = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
        with torch.inference_mode():
            return params.prefill(inp, pad_to=pad_to)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, state) -> (logits [B, V], new_caches,
    cache_len + 1)``; ``state`` holds ``token`` (or ``embed``), ``caches``
    and ``cache_len``."""

    def decode_step(params: Model, state):
        _check(cfg, params)
        tok = state["token"] if cfg.embed_inputs else state["embed"]
        with torch.inference_mode():
            logits, new_caches = params.decode_step(state["caches"], tok, state["cache_len"])
        return logits, new_caches, state["cache_len"] + 1

    return decode_step
