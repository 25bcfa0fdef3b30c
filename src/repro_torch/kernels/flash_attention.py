"""Binding and wrapper of the hand-written Hopper flash attention kernel.

``csrc/flash_attention.cu`` (its header says which TPU kernel it replaces,
what bounds it and what the design does about that) is its own shared
library with plain C entry points, built by :mod:`.build` at first use.
Nothing is built or loaded when this module is imported.

The wrapper takes CUDA tensors only; :func:`repro_torch.kernels.ops.attention`
dispatches CPU tensors to the plain version
(:func:`repro_torch.kernels.ref.mha_attention`).  ``flash_launches`` counts
its calls.  It picks one of the file's three kernels with :func:`variant`:
the split-KV decode kernel (two launches: the splits, then their merge;
mirrored by :func:`repro_torch.kernels.ref.split_kv_attention`) when a KV
head serves at most ``DECODE_MAX_ROWS`` query rows, else the bf16 wgmma
kernel (128 query rows by ``BLOCK_K`` keys) or the f32 CUDA-core kernel (64
by 64).  The TPU kernel's ``block_q`` / ``block_k`` have no role here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .build import check_tensor, load, raise_on

__all__ = [
    "BLOCK_K", "DECODE_CTAS", "DECODE_MAX_ROWS", "HEAD_DIMS", "decode_splits",
    "flash_attention", "flash_launches", "variant",
]

HEAD_DIMS = (32, 64, 128)  # head dims the kernels are instantiated for
BLOCK_K = 128  # keys of a KV tile of the bf16 kernel (flash_attention.cu's wg::kBN)
DECODE_MAX_ROWS = 4  # query rows (Sq x H/Hk) a KV head may serve in the decode kernel
DECODE_CTAS = 264  # decode CTAs to aim for: two for each of an H100's 132 SMs

flash_launches = 0  # calls of flash_attention that launched a kernel


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 8 + [f32, i32, ptr]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_decode_launch.argtypes = (
        [ptr] * 6 + [i32] * 8 + [f32, i32, i32, i32, ptr]
    )
    lib.flash_attention_decode_launch.restype = i32


def variant(dtype: torch.dtype, Sq: int, H: int, Hk: int) -> str:
    """The kernel a call takes: ``"decode"`` when each KV head serves at
    most ``DECODE_MAX_ROWS`` query rows (Sq x H/Hk), else ``"wgmma"`` for
    bf16 and ``"f32"`` for f32."""
    if Sq * (H // Hk) <= DECODE_MAX_ROWS:
        return "decode"
    return "wgmma" if dtype == torch.bfloat16 else "f32"


def decode_splits(B: int, Hk: int, Sq: int, Sk: int, q_offset: int,
                  causal: bool) -> Tuple[int, int]:
    """``(split_len, n_splits)`` of the decode kernel: the visible keys
    (those up to ``q_offset + Sq - 1``, or all Sk) cut into splits of whole
    ``BLOCK_K`` tiles, as few as give about ``DECODE_CTAS`` CTAs of ``B x Hk
    x n_splits``, each split at least one tile."""
    kend = Sk if not causal else max(0, min(Sk, q_offset + Sq))
    tiles = max(1, math.ceil(kend / BLOCK_K))
    want = min(tiles, max(1, math.ceil(DECODE_CTAS / (B * Hk))))
    split_len = math.ceil(tiles / want) * BLOCK_K
    return split_len, max(1, math.ceil(kend / split_len))


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D] f32 or bf16 CUDA
    k: torch.Tensor,  # [B, Hk, Sk, D], q's dtype
    v: torch.Tensor,  # [B, Hk, Sk, D], q's dtype
    q_offset: int = 0,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch GQA flash attention on the current stream (the kernel
    :func:`variant` picks); returns ``o [B, H, Sq, D]`` in q's dtype with the
    semantics of :func:`repro_torch.kernels.ref.mha_attention` (``scale``
    defaults to ``D ** -0.5``), except that a row with no visible key is 0.
    Does not synchronize."""
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries (TMA and vector loads)")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    which = variant(q.dtype, Sq, H, Hk)
    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = load("flash_attention", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "decode":
            split_len, n_splits = decode_splits(B, Hk, Sq, Sk, int(q_offset), bool(causal))
            rows = B * H * Sq * n_splits
            # each split's partial (m, l) per row, then its acc [rows, D]
            part = torch.empty(rows * (2 + D), dtype=torch.float32, device=q.device)
            rc = lib.flash_attention_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), part.data_ptr(),
                part[rows * 2:].data_ptr(), B, H, Hk, Sq, Sk, D, int(q_offset),
                int(bool(causal)), float(scale), is_bf16, split_len, n_splits, stream,
            )
        else:
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hk, Sq, Sk, D,
                int(q_offset), int(bool(causal)), float(scale), is_bf16, stream,
            )
    raise_on(rc, "flash_attention", lib, "flash_attention")
    flash_launches += 1
    return o
