"""Step-function builders shared by the trainer and the server (port of
``repro/launch/steps.py``: ``make_train_step``, ``abstract_train_state``,
``make_prefill_step`` and ``make_decode_step``).

As in the reference, a step takes the parameters explicitly: here the
:class:`~repro_torch.models.model.Model` that holds them (built on the card
by default), then the optimizer state and batch, or the batch, or the
decode state.  The serving steps run under ``torch.inference_mode()``; the
train step runs the loss, its backward pass and AdamW in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.analyzer import _check_device
from ..models.config import ModelConfig
from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compression import ef_compress, init_error_state

__all__ = ["abstract_train_state", "make_decode_step", "make_prefill_step", "make_train_step"]


def _check(cfg: ModelConfig, params: Model) -> None:
    if params.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is {params.cfg.name}")


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig, compress_grads: bool = False, device="cuda"
):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for a model on ``device``: the loss, its backward pass, with
    ``compress_grads`` the int8 error-feedback compression of the gradients
    (the residual rides in ``opt_state['ef']``), then AdamW in place.
    ``opt_state`` is ``{'adam': adamw_init(...), 'ef': {} or
    init_error_state(...)}``; ``metrics`` holds ``loss``, ``ce``, ``aux``,
    ``lr`` and ``grad_norm`` as f32 scalars on the device.  The step turns
    the model's gradients on and leaves none behind.

    On the card a model with Mamba2 layers is refused here, before any
    work: its backward pass would run through the SSD kernel, which has no
    backward kernel (``kernels.ops.ssd`` refuses it too; the reference has
    none either).  So the ssm and hybrid families train on the CPU only,
    through the plain chunked scan's autograd; the dense and moe families
    train on either."""
    dev = torch.device(device)
    if dev.type == "cuda" and cfg.mamba_layers_per_group:
        raise NotImplementedError(
            f"training {cfg.name} on the card needs the SSD backward kernel (an "
            "autograd.Function around ssd_scan.cu), which neither package has; the ssm "
            "and hybrid families train with device='cpu'"
        )
    dev = _check_device(dev)

    def train_step(params: Model, opt_state, batch):
        _check(cfg, params)
        here = params.device
        if here.type != dev.type or dev.index not in (None, here.index):
            raise ValueError(f"the step was built for {dev}, the model is on {here}")
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        loss, parts = params.loss(batch)
        loss.backward()
        named = dict(params.named_parameters())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        params.zero_grad(set_to_none=True)
        new_opt = {"ef": opt_state["ef"]}
        if compress_grads:
            grads, new_opt["ef"] = ef_compress(grads, opt_state["ef"])
        _, new_opt["adam"], om = adamw_update(named, grads, opt_state["adam"], opt_cfg)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}, **om}
        return params, new_opt, metrics

    return train_step


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, compress_grads: bool = False):
    """``(params, opt_state)`` on the ``meta`` device: every shape and
    dtype of the train state, nothing allocated."""
    model = Model(cfg, device="meta")
    ef = init_error_state(model) if compress_grads else {}
    return model, {"adam": adamw_init(model, opt_cfg), "ef": ef}


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
