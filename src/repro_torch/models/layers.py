"""Shared building blocks: the RMS and layer norms, the fan-in initializer,
the gated (SwiGLU) MLP and the plain GELU MLP (port of
``repro/models/layers.py``).

Initializers take an explicit ``torch.Generator`` and return f32 tensors on
its device, or on ``device`` when given (``"meta"``: shapes only, drawn
from a CPU generator); the compute dtype (bf16) is handled by callers casting
activations and weights at use, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

__all__ = [
    "dense_mlp",
    "gated_mlp",
    "init_dense_mlp",
    "init_gated_mlp",
    "init_linear",
    "layer_norm",
    "rms_norm",
    "truncated_normal",
]


def truncated_normal(gen: torch.Generator, shape: Sequence[int], device=None) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], f32 on ``device`` (default:
    the generator's)."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device or gen.device)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=gen)


def init_linear(
    gen: torch.Generator, d_in: int, d_out: int, scale: Optional[float] = None, device=None
) -> torch.Tensor:
    """Truncated-normal fan-in init (the LLaMA/PaLM convention), stored
    ``[d_in, d_out]`` and applied as ``x @ W``, the reference's layout."""
    if scale is None:
        scale = d_in ** -0.5
    return truncated_normal(gen, (d_in, d_out), device) * scale


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gain).to(x.dtype)


def layer_norm(
    x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Layer norm in f32 with the population variance (``jnp.var``'s, not
    torch's unbiased default), cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * gain + bias).to(x.dtype)


def init_gated_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, device=None
) -> Dict[str, torch.Tensor]:
    """The SwiGLU MLP's ``wi`` (gate), ``wu`` (up) and ``wo`` (down)."""
    return {
        "wi": init_linear(gen, d_model, d_ff, device=device),
        "wu": init_linear(gen, d_model, d_ff, device=device),
        "wo": init_linear(gen, d_ff, d_model, scale=d_ff ** -0.5, device=device),
    }


def gated_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x·wi) * x·wu)·wo`` in x's dtype, the LLaMA-family MLP."""
    dt = x.dtype
    h = torch.nn.functional.silu(x @ p["wi"].to(dt)) * (x @ p["wu"].to(dt))
    return h @ p["wo"].to(dt)


def init_dense_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, device=None
) -> Dict[str, torch.Tensor]:
    """The plain MLP's ``wi`` (up) and ``wo`` (down)."""
    return {
        "wi": init_linear(gen, d_model, d_ff, device=device),
        "wo": init_linear(gen, d_ff, d_model, scale=d_ff ** -0.5, device=device),
    }


def dense_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x·wi)·wo`` in x's dtype, with the tanh form of GELU
    (``jax.nn.gelu``'s default): the StarCoder2 and encoder MLP."""
    dt = x.dtype
    h = torch.nn.functional.gelu(x @ p["wi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt)
