"""Shared building blocks: the RMS norm and the fan-in initializer (port of
``repro/models/layers.py``).

Initializers take an explicit ``torch.Generator`` and return f32 tensors on
its device; the compute dtype (bf16) is handled by callers casting
activations and weights at use, as the reference does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["init_linear", "rms_norm", "truncated_normal"]


def truncated_normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], f32 on the generator's device."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=gen)


def init_linear(
    gen: torch.Generator, d_in: int, d_out: int, scale: Optional[float] = None
) -> torch.Tensor:
    """Truncated-normal fan-in init (the LLaMA/PaLM convention), stored
    ``[d_in, d_out]`` and applied as ``x @ W``, the reference's layout."""
    if scale is None:
        scale = d_in ** -0.5
    return truncated_normal(gen, (d_in, d_out)) * scale


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gain).to(x.dtype)
