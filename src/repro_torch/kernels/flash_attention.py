"""Binding and wrapper of the hand-written Hopper flash attention kernel.

``csrc/flash_attention.cu`` (its header says which TPU kernel it replaces,
what bounds it and what the design does about that) is its own shared
library with plain C entry points, built by :mod:`.build` at first use.
Nothing is built or loaded when this module is imported.

The wrapper takes CUDA tensors only; :func:`repro_torch.kernels.ops.attention`
dispatches CPU tensors to the plain version
(:func:`repro_torch.kernels.ref.mha_attention`).  ``flash_launches`` counts
the launches it made.  The kernel picks its own tiles (64 query rows by 64
keys); the TPU kernel's ``block_q`` / ``block_k`` have no role here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import check_tensor, load, raise_on

__all__ = ["BLOCK_K", "HEAD_DIMS", "flash_attention", "flash_launches"]

HEAD_DIMS = (32, 64, 128)  # head dims the kernel is instantiated for
BLOCK_K = 64  # keys of a KV tile (flash_attention.cu's kBK)

flash_launches = 0  # kernel launches made by flash_attention


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 8 + [ctypes.c_float, i32, ptr]
    )
    lib.flash_attention_launch.restype = i32


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D] f32 or bf16 CUDA
    k: torch.Tensor,  # [B, Hk, Sk, D], q's dtype
    v: torch.Tensor,  # [B, Hk, Sk, D], q's dtype
    q_offset: int = 0,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch GQA flash attention on the current stream; returns ``o [B, H,
    Sq, D]`` in q's dtype with the semantics of
    :func:`repro_torch.kernels.ref.mha_attention` (``scale`` defaults to
    ``D ** -0.5``), except that a row with no visible key is 0.  Does not
    synchronize."""
    global flash_launches
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    check_tensor("q", q, q.dtype, 4)
    check_tensor("k", k, q.dtype, 4)
    check_tensor("v", v, q.dtype, 4)
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hk, Sk, D) or v.shape != k.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not agree"
        )
    if Hk == 0 or H % Hk:
        raise ValueError(f"GQA needs H % Hk == 0, got H={H}, Hk={Hk}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = load("flash_attention", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hk, Sq, Sk, D,
            int(q_offset), int(bool(causal)), float(scale), int(q.dtype == torch.bfloat16),
            stream,
        )
    raise_on(rc, "flash_attention", lib, "flash_attention")
    flash_launches += 1
    return o
