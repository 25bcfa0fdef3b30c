"""Published model configurations (structure only, no weights): the
architecture registry and the assigned input shapes, a copy of
``repro/configs/__init__.py``.

40 assigned cells = 10 archs × 4 shapes.  ``cells()`` enumerates the
runnable ones and records every skip with its reason (full-attention archs
skip long_500k; the encoder-only arch skips decode shapes).

The reference's ``input_specs`` (the step inputs of one cell, decode caches
included) needs ``Model.init_caches`` for every family, so it arrives with
the families' forward passes (slice 7 of the port).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.models import ModelConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "Shape",
    "cells",
    "get_config",
    "get_smoke",
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
