"""GQA attention with RoPE, qk-norm and a KV cache, and the memory-efficient
plain flash path (port of ``repro/models/attention.py``).

:func:`chunked_attention` is the reference's online-softmax double loop
over ``[bq, bk]`` blocks, plain tensor ops: the model's prefill runs it, as
the reference's does.  The hand-written flash kernel is reached only
through :func:`repro_torch.kernels.ops.attention`, the reference's own
structure (its model never calls the Pallas kernel).

RoPE variants: ``'rope'`` (standard 1-d rotary: Qwen3, Mistral, Granite,
Jamba, StarCoder2), ``'rope2d'`` (ChatGLM: rotary halves on position
streams 0 and 1), ``'mrope'`` (Qwen2-VL M-RoPE: sections of ``D//2``,
``D//4`` and the rest on streams 0, 1 and 2, each with its own
frequencies) and ``'none'`` (HuBERT).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from .layers import init_linear, rms_norm

__all__ = [
    "apply_rope",
    "attention_block",
    "chunked_attention",
    "decode_attention",
    "decode_attention_block",
    "init_attention",
    "rope_frequencies",
]

Params = Mapping[str, torch.Tensor]

_NEG = -1e30  # the reference's mask value


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #


def rope_frequencies(d: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    """Inverse frequencies for a rotary span of ``d`` dims (d even), f32."""
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponents)


def _rotate(x: torch.Tensor, pos: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x [..., S, d_span] rotated by pos [..., S] (broadcastable), in f32,
    returned in x's dtype."""
    ang = pos[..., None].to(torch.float32) * inv_freq  # [..., S, d/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # [B, H, S, D]
    positions: torch.Tensor,  # [B, S] ('rope') or [B, n_streams, S]
    variant: str = "rope",
    theta: float = 10_000.0,
) -> torch.Tensor:
    if variant == "none":
        return x
    if variant == "rope":
        pos = positions if positions.dim() == 2 else positions[:, 0]
        inv = rope_frequencies(x.shape[-1], theta, device=x.device)
        return _rotate(x, pos[:, None, :], inv)
    D = x.shape[-1]
    if variant == "rope2d":
        # ChatGLM: two independent rotary halves on two position streams
        if positions.dim() != 3 or positions.shape[1] < 2:
            raise ValueError(f"rope2d needs [B, 2, S] positions, got {tuple(positions.shape)}")
        half = D // 2
        inv = rope_frequencies(half, theta, device=x.device)
        return torch.cat([_rotate(x[..., :half], positions[:, 0][:, None, :], inv),
                          _rotate(x[..., half:], positions[:, 1][:, None, :], inv)], dim=-1)
    if variant == "mrope":
        # Qwen2-VL: 3 sections (t, h, w) of D//2, D//4 and the rest
        if positions.dim() != 3 or positions.shape[1] < 3:
            raise ValueError(f"mrope needs [B, 3, S] positions, got {tuple(positions.shape)}")
        s_t, s_h = D // 2, D // 4
        parts, off = [], 0
        for span, stream in ((s_t, 0), (s_h, 1), (D - s_t - s_h, 2)):
            inv = rope_frequencies(span, theta, device=x.device)
            parts.append(_rotate(x[..., off:off + span], positions[:, stream][:, None, :], inv))
            off += span
        return torch.cat(parts, dim=-1)
    raise ValueError(f"unknown rope variant {variant!r}")


# --------------------------------------------------------------------------- #
# Memory-efficient attention (plain tensor ops)
# --------------------------------------------------------------------------- #


def chunked_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hk, Sk, D]
    v: torch.Tensor,  # [B, Hk, Sk, D]
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
    block_q: int = 1024,
    block_k: int = 1024,
    window: Optional[int] = None,  # sliding-window span
) -> torch.Tensor:
    """Online-softmax attention over ``[bq, bk]`` blocks in f32, peak live
    buffer ``[B, H, bq, bk]``; returned in q's dtype.  Sequences are padded
    to block multiples and the padded keys masked; masked scores are
    ``-1e30``; a row whose sum stays 0 returns 0 (the ``l > 0`` guard).
    Every KV block is visited, as in the reference (no causal skipping)."""
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    g = H // Hk
    if scale is None:
        scale = D ** -0.5
    block_q, block_k = min(block_q, Sq), min(block_k, Sk)
    pq, pk = (-Sq) % block_q, (-Sk) % block_k
    f32, dev = torch.float32, q.device
    qp = torch.nn.functional.pad(q, (0, 0, 0, pq)) if pq else q
    kp = torch.nn.functional.pad(k, (0, 0, 0, pk)) if pk else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, pk)) if pk else v
    nq, nk = qp.shape[2] // block_q, kp.shape[2] // block_k
    qg = qp.reshape(B, Hk, g, nq * block_q, D)  # fold GQA: [B, Hk, g, S, D]

    outs = []
    for qi in range(nq):
        qtile = qg[:, :, :, qi * block_q:(qi + 1) * block_q].to(f32)
        q_pos = q_offset + qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, Hk, g, block_q), _NEG, dtype=f32, device=dev)
        l = torch.zeros((B, Hk, g, block_q), dtype=f32, device=dev)
        acc = torch.zeros((B, Hk, g, block_q, D), dtype=f32, device=dev)
        for ki in range(nk):
            ktile = kp[:, :, ki * block_k:(ki + 1) * block_k].to(f32)
            vtile = vp[:, :, ki * block_k:(ki + 1) * block_k].to(f32)
            k_pos = ki * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qtile, ktile) * scale
            mask = (k_pos < Sk)[None, :]  # padded keys
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vtile)
            m = m_new
        denom = torch.where(l > 0, l, 1.0)
        outs.append((acc / denom[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3).reshape(B, H, nq * block_q, D)
    return out[:, :, :Sq]


# --------------------------------------------------------------------------- #
# Attention block (projections + rope + cache)
# --------------------------------------------------------------------------- #


def init_attention(
    gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int, d_head: int,
    qk_norm: bool = False, device=None,
) -> Dict[str, torch.Tensor]:
    """The reference's initial distributions, drawn from ``gen`` on
    ``device`` (default: its own), f32; matrices ``[d_in, d_out]``."""
    dev = device or gen.device
    hd = n_heads * d_head
    p = {
        "wq": init_linear(gen, d_model, hd, device=dev),
        "wk": init_linear(gen, d_model, n_kv_heads * d_head, device=dev),
        "wv": init_linear(gen, d_model, n_kv_heads * d_head, device=dev),
        "wo": init_linear(gen, hd, d_model, scale=hd ** -0.5, device=dev),
    }
    if qk_norm:
        p["q_norm"] = torch.ones(d_head, device=dev)
        p["k_norm"] = torch.ones(d_head, device=dev)
    return p


def _project_qkv(p: Params, x, n_heads, n_kv_heads, d_head, positions, rope_variant, qk_norm,
                 theta):
    """q [B, H, S, D], k and v [B, Hk, S, D] in x's dtype; the qk-norm
    comes before RoPE."""
    B, S, _ = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, n_heads, d_head).transpose(1, 2)
    k = (x @ p["wk"].to(dt)).reshape(B, S, n_kv_heads, d_head).transpose(1, 2)
    v = (x @ p["wv"].to(dt)).reshape(B, S, n_kv_heads, d_head).transpose(1, 2)
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return (apply_rope(q, positions, rope_variant, theta),
            apply_rope(k, positions, rope_variant, theta), v)


def attention_block(
    p: Params,
    x: torch.Tensor,  # [B, S, d_model]
    positions: torch.Tensor,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    causal: bool = True,
    rope_variant: str = "rope",
    qk_norm: bool = False,
    theta: float = 10_000.0,
    window: Optional[int] = None,
    block_q: int = 1024,
    block_k: int = 1024,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, d_head, positions, rope_variant,
                           qk_norm, theta)
    o = chunked_attention(q, k, v, causal=causal, block_q=block_q, block_k=block_k,
                          window=window)
    o = o.transpose(1, 2).reshape(B, S, n_heads * d_head)
    return o @ p["wo"].to(x.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, H, 1, D]
    ck: torch.Tensor,  # [B, Hk, Smax, D]
    cv: torch.Tensor,  # [B, Hk, Smax, D]
    cache_len: int,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query per sequence against the whole padded cache: a masked
    softmax over the keys at or below ``cache_len`` (the token's own slot),
    in f32; returns ``[B, H, 1, D]`` f32."""
    B, H, _, D = q.shape
    Hk, Smax = ck.shape[1], ck.shape[2]
    f32 = torch.float32
    qg = q.reshape(B, Hk, H // Hk, 1, D).to(f32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, ck.to(f32)) * (D ** -0.5)
    kpos = torch.arange(Smax, device=q.device)
    mask = kpos <= cache_len
    if window is not None:
        mask = mask & (kpos > cache_len - window)
    w = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", w, cv.to(f32)).reshape(B, H, 1, D)


def decode_attention_block(
    p: Params,
    x: torch.Tensor,  # [B, 1, d_model]
    positions: torch.Tensor,  # [B, 1]
    kv_cache: Tuple[torch.Tensor, torch.Tensor],  # ([B, Hk, Smax, D], ...)
    cache_len: int,  # current cache fill: the token's slot
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    rope_variant: str = "rope",
    qk_norm: bool = False,
    theta: float = 10_000.0,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode; returns (out, (ck, cv)).

    The token's K and V are written into the cache **in place**, at slot
    ``cache_len`` (the reference returns an updated copy); the returned
    cache is the same pair of tensors.  A slot past the padded cache
    raises ``IndexError`` (the reference's ``dynamic_update_slice`` clamps
    the index and overwrites the last slot)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, d_head, positions, rope_variant,
                           qk_norm, theta)
    ck, cv = kv_cache
    ck[:, :, cache_len] = k[:, :, 0].to(ck.dtype)
    cv[:, :, cache_len] = v[:, :, 0].to(cv.dtype)
    o = decode_attention(q, ck, cv, cache_len, window)
    o = o.transpose(1, 2).reshape(B, 1, n_heads * d_head)
    return o.to(x.dtype) @ p["wo"].to(x.dtype), (ck, cv)
