"""Mamba2 block (SSD mixer), attention-free sequence mixing (port of
``repro/models/mamba2.py``).

Structure (Dao & Gu 2024, simplified to 1 B/C group):

  in_proj -> [z (H·P), x (H·P), B (N), C (N), dt (H)]
  depthwise causal conv1d (kernel 4) on x
  SSD scan (:func:`repro_torch.kernels.ops.ssd`: the CUDA kernel on the
  card, the plain chunked version on the CPU)
  gate: y ⊙ silu(z); RMSNorm; out_proj

Dtypes as in the reference: activations in the caller's dtype (bf16), f32
``dt``/``B``/``C`` into the scan, f32 state.  Decode keeps two caches per
layer, the conv tail [B, K-1, H·P] and the SSM state [B, H, N, P]; a decode
step is O(1) in sequence length.  Only :func:`repro_torch.kernels.ops.ssd`
reaches a kernel: ``_final_state`` and decode are plain tensor ops, as in
the reference.

Parameters are a mapping of tensors (an ``nn.ParameterDict`` inside the
model) with the reference's names and layouts.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..core.analyzer import _check_device
from ..kernels import ops
from .config import CONV_K
from .layers import init_linear, rms_norm, truncated_normal

__all__ = [
    "init_mamba2",
    "init_mamba2_cache",
    "mamba2_block",
    "mamba2_decode",
    "mamba2_prefill",
]

Params = Mapping[str, torch.Tensor]


def init_mamba2(
    gen: torch.Generator, d_model: int, n_heads: int, d_head: int, d_state: int, device=None
) -> Dict[str, torch.Tensor]:
    """The reference's initial distributions, drawn from ``gen`` on
    ``device`` (default: its own), f32."""
    di = n_heads * d_head  # inner width
    dev = device or gen.device
    return {
        "in_proj": init_linear(gen, d_model, 2 * di + 2 * d_state + n_heads, device=dev),
        "conv_w": truncated_normal(gen, (CONV_K, di), dev) * 0.3,
        "A_log": torch.log(torch.linspace(1.0, 8.0, n_heads, device=dev)),
        "dt_bias": torch.zeros(n_heads, device=dev),
        "D": torch.ones(n_heads, device=dev),  # skip connection
        "norm": torch.ones(di, device=dev),
        "out_proj": init_linear(gen, di, d_model, scale=di ** -0.5, device=dev),
    }


def _pad_seq(chunk: int, *arrays: torch.Tensor):
    """Pad the seq axis (axis 1) to a chunk multiple.  Zero-padding is exact
    for the SSD recurrence: padded steps have dt=0 (decay 1, zero input), so
    the state is unchanged and padded outputs are sliced away."""
    S = arrays[0].shape[1]
    pad = (-S) % chunk
    if pad == 0:
        return S, arrays
    out = tuple(F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in arrays)
    return S, out


def _split_proj(p: Params, u: torch.Tensor, n_heads: int, d_head: int, d_state: int):
    di = n_heads * d_head
    z = u[..., :di]
    x = u[..., di: 2 * di]
    Bm = u[..., 2 * di: 2 * di + d_state]
    Cm = u[..., 2 * di + d_state: 2 * di + 2 * d_state]
    dt = F.softplus(u[..., 2 * di + 2 * d_state:].float() + p["dt_bias"])
    return z, x, Bm, Cm, dt


def _causal_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (kernel CONV_K) over the sequence, then silu,
    in x's dtype."""
    S = x.shape[1]
    xp = F.pad(x, (0, 0, CONV_K - 1, 0))
    w = p["conv_w"].to(x.dtype)
    conv = sum(xp[:, i: i + S, :] * w[i] for i in range(CONV_K))
    return F.silu(conv)


def _mix(p: Params, h, n_heads, d_head, d_state, chunk):
    """The shared body of block and prefill: ``(out, (x_pre, xh, dt, A,
    Bf))``, the pre-conv stream and the scan's inputs for the cache."""
    B, S, _ = h.shape
    di = n_heads * d_head
    u = h @ p["in_proj"].to(h.dtype)
    z, x, Bm, Cm, dt = _split_proj(p, u, n_heads, d_head, d_state)
    x_pre = x
    x = _causal_conv(p, x)

    A = -torch.exp(p["A_log"])  # [H] negative decay rates
    xh = x.reshape(B, S, n_heads, d_head)
    Bf, Cf = Bm.float(), Cm.float()
    _, (xh_p, dt_p, B_p, C_p) = _pad_seq(chunk, xh, dt, Bf, Cf)
    y = ops.ssd(xh_p.contiguous(), dt_p.contiguous(), A, B_p.contiguous(),
                C_p.contiguous(), chunk=chunk)[:, :S]
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)  # skip
    y = y.reshape(B, S, di)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"])
    return y @ p["out_proj"].to(h.dtype), (x_pre, xh, dt, A, Bf)


def mamba2_block(
    p: Params,
    h: torch.Tensor,  # [B, S, d_model]
    n_heads: int,
    d_head: int,
    d_state: int,
    chunk: int = 128,
) -> torch.Tensor:
    return _mix(p, h, n_heads, d_head, d_state, chunk)[0]


def _final_state(xh, dt, A, Bm, chunk: int = 128) -> torch.Tensor:
    """SSM state after the full sequence (for the prefill -> decode
    handoff): h_final = sum_s dt_s·exp(sum_{u>s} a_u)·B_s ⊗ x_s, computed
    chunk-blocked, per-chunk partial states folded left to right with the
    chunk decays."""
    B, S0, H, P = xh.shape
    chunk = min(chunk, S0)
    _, (xh, dt, Bm) = _pad_seq(chunk, xh, dt, Bm)
    S = xh.shape[1]
    N = Bm.shape[-1]
    C = S // chunk
    f32 = torch.float32
    x_ = xh.to(f32).reshape(B, C, chunk, H, P)
    dt_ = dt.to(f32).reshape(B, C, chunk, H)
    B_ = Bm.to(f32).reshape(B, C, chunk, N)
    acum = torch.cumsum(A.to(f32) * dt_, dim=2)
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)
    S_c = torch.einsum("bcsn,bcshp->bchnp", B_, (dt_ * decay_to_end)[..., None] * x_)
    chunk_decay = torch.exp(acum[:, :, -1, :])  # [B, C, H]
    h = torch.zeros((B, H, N, P), dtype=f32, device=xh.device)
    for c in range(C):
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    return h  # [B, H, N, P]


def mamba2_prefill(
    p: Params,
    h: torch.Tensor,  # [B, S, d_model]
    n_heads: int,
    d_head: int,
    d_state: int,
    chunk: int = 128,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward that also returns the decode cache."""
    S = h.shape[1]
    out, (x_pre, xh, dt, A, Bf) = _mix(p, h, n_heads, d_head, d_state, chunk)
    cache = {
        "conv": x_pre[:, S - (CONV_K - 1):, :].float(),  # pre-conv stream tail
        "ssm": _final_state(xh, dt, A, Bf, chunk=chunk),
    }
    return out, cache


def init_mamba2_cache(
    batch: int, n_heads: int, d_head: int, d_state: int,
    dtype: torch.dtype = torch.float32, device="cuda",
) -> Dict[str, torch.Tensor]:
    di = n_heads * d_head
    device = _check_device(device)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, n_heads, d_state, d_head), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(
    p: Params,
    h: torch.Tensor,  # [B, 1, d_model]
    cache: Mapping[str, torch.Tensor],
    n_heads: int,
    d_head: int,
    d_state: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B = h.shape[0]
    di = n_heads * d_head
    u = h @ p["in_proj"].to(h.dtype)
    z, x, Bm, Cm, dt = _split_proj(p, u, n_heads, d_head, d_state)
    x = x[:, 0]  # [B, di]
    z = z[:, 0]
    Bm = Bm[:, 0].float()  # [B, N]
    Cm = Cm[:, 0].float()
    dt = dt[:, 0]  # [B, H]

    # conv cache: window = [tail, x]
    win = torch.cat([cache["conv"], x[:, None, :].to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(h.dtype)
    conv = sum(win[:, i, :] * w[i] for i in range(CONV_K))
    xc = F.silu(conv)  # [B, di]
    new_conv = win[:, 1:, :]

    A = -torch.exp(p["A_log"])  # [H]
    xh = xc.reshape(B, n_heads, d_head).float()
    dec = torch.exp(A[None, :] * dt)  # [B, H]
    s = cache["ssm"]  # [B, H, N, P]
    s = dec[..., None, None] * s + dt[..., None, None] * (
        Bm[:, None, :, None] * xh[:, :, None, :]
    )
    y = torch.einsum("bn,bhnp->bhp", Cm, s)  # [B, H, P]
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, di).to(h.dtype)

    y = y * F.silu(z)
    y = rms_norm(y, p["norm"])
    out = (y @ p["out_proj"].to(h.dtype)).reshape(B, 1, -1)
    return out, {"conv": new_conv, "ssm": s}
