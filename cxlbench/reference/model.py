"""A dense transformer's forward pass in plain PyTorch float32: the
reference for a prefill's last logits.  Tied embeddings, RMS norms (eps
1e-6) or, under ``norm: "ln"``, layer norms with a bias (eps 1e-5, the
population variance), rotary positions on the two halves of each head (theta from the
configuration), causal grouped-query attention with 1/sqrt(d_head) scores,
and a plain MLP with the tanh form of GELU.  TF32 is off for its products.

``fp8=True`` is the control: every product's two operands are first
rounded to float8 e4m3 with one scale a tensor (its largest magnitude to
448), one precision below the bfloat16 the served model computes in.
Nothing here imports the program; the weights are the benchmark's own."""

from __future__ import annotations

from typing import Dict

import torch

F8_MAX = 448.0  # float8 e4m3's largest finite value


def _f8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = _f8(a), _f8(b)
    return a @ b


def _norm(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    if name in w:  # RMS: one gain
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * w[name]
    c = x - x.mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(c.square().mean(dim=-1, keepdim=True) + 1e-5) * w[name + ".g"] \
        + w[name + ".b"]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def last_logits(w: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
                fp8: bool = False) -> torch.Tensor:
    """``[n, vocab]`` f32 logits at the last position of each row of
    ``tokens [n, S]``, one row at a time."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return torch.cat([_row(w, m, tokens[i], fp8) for i in range(tokens.shape[0])])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _row(w, m, tok, fp8):
    S, H, Hk, Dh = tok.shape[0], m["n_heads"], m["n_kv_heads"], m["d_head"]
    dev = tok.device
    inv = 1.0 / torch.pow(torch.tensor(float(m["rope_theta"]), device=dev),
                          torch.arange(0, Dh, 2, dtype=torch.float32, device=dev) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=dev)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    x = w["embed"][tok]
    for g in range(m["n_layers"]):
        p = f"blocks.{g}.sub0."
        h = _norm(x, w, p + "norm1")
        q = _rope(_mm(h, w[p + "attn.wq"], fp8).view(S, H, Dh).transpose(0, 1), cos, sin)
        k = _rope(_mm(h, w[p + "attn.wk"], fp8).view(S, Hk, Dh).transpose(0, 1), cos, sin)
        v = _mm(h, w[p + "attn.wv"], fp8).view(S, Hk, Dh).transpose(0, 1)
        o = torch.empty((H, S, Dh), dtype=torch.float32, device=dev)
        g_size = H // Hk
        for j in range(Hk):
            qs = q[j * g_size:(j + 1) * g_size]
            s = _mm(qs, k[j].T, fp8) * Dh ** -0.5
            s = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            o[j * g_size:(j + 1) * g_size] = _mm(s, v[j], fp8)
            del s
        x = x + _mm(o.transpose(0, 1).reshape(S, H * Dh), w[p + "attn.wo"], fp8)
        h = _norm(x, w, p + "norm2")
        up = torch.nn.functional.gelu(_mm(h, w[p + "mlp.wi"], fp8), approximate="tanh")
        x = x + _mm(up, w[p + "mlp.wo"], fp8)
    xn = _norm(x[-1:], w, "final_norm")
    return _mm(xn, w["embed"].T, fp8)
