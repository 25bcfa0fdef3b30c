"""Published model configurations (structure only, no weights): the
architecture registry, the assigned input shapes and ``input_specs``, a
port of ``repro/configs/__init__.py``.

40 assigned cells = 10 archs × 4 shapes.  ``cells()`` enumerates the
runnable ones and records every skip with its reason (full-attention archs
skip long_500k; the encoder-only arch skips decode shapes).
``input_specs`` gives one cell's step inputs, decode caches included, as
``meta`` tensors (the reference's ``ShapeDtypeStruct``s): shapes and
dtypes, nothing allocated.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import Model, ModelConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "Shape",
    "cells",
    "get_config",
    "get_smoke",
    "input_specs",
]

_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# families whose attention is full/quadratic -> long_500k skipped
_FULL_ATTENTION = ("dense", "moe", "vlm")


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, shape: Optional[str] = None) -> ModelConfig:
    mod = _module(arch)
    cfg = mod.CONFIG
    if shape == "long_500k" and hasattr(mod, "LONG"):
        cfg = mod.LONG  # e.g. Jamba enables windowed attention at 500k
    return cfg


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def cells() -> List[Dict[str, Any]]:
    """All 40 (arch × shape) cells with runnable flag + skip reason."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            skip = None
            if shape.kind == "decode" and cfg.family == "audio":
                skip = "encoder-only: no decode step"
            elif sname == "long_500k" and cfg.family in _FULL_ATTENTION:
                skip = "full quadratic attention: 500k decode infeasible by design"
            out.append(
                {"arch": arch, "shape": sname, "runnable": skip is None, "skip": skip}
            )
    return out


# --------------------------------------------------------------------------- #
# input specs (meta tensors; no allocation)
# --------------------------------------------------------------------------- #


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(
    cfg: ModelConfig, shape: Shape, batch_override: Optional[int] = None
) -> Dict[str, Any]:
    """Meta-tensor tree for one step of (cfg × shape):

    train:   {'tokens'|'embeds', 'labels'}
    prefill: {'tokens'|'embeds'}
    decode:  {'caches', 'token'|'embed', 'cache_len'}

    Tokens, labels and ``cache_len`` (0-d) are int32; embeddings are
    ``[B, S, d_model]`` in ``cfg.dtype``; the caches are a meta model's
    ``init_caches(B, S)``."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        if cfg.embed_inputs:
            inp = {"tokens": _spec((B, S), i32)}
        else:
            inp = {"embeds": _spec((B, S, cfg.d_model), cfg.dtype)}
        inp["labels"] = _spec((B, S), i32)
        return inp
    if shape.kind == "prefill":
        if cfg.embed_inputs:
            return {"tokens": _spec((B, S), i32)}
        return {"embeds": _spec((B, S, cfg.d_model), cfg.dtype)}
    if shape.kind == "decode":
        caches = Model(cfg, device="meta").init_caches(B, S)
        if cfg.embed_inputs:
            tok = {"token": _spec((B, 1), i32)}
        else:
            tok = {"embed": _spec((B, 1, cfg.d_model), cfg.dtype)}
        return {"caches": caches, **tok, "cache_len": _spec((), i32)}
    raise ValueError(shape.kind)
