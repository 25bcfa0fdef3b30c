"""Binding and wrapper of the hand-written Hopper SSD scan kernel.

``csrc/ssd_scan.cu`` (its header says which TPU kernel it replaces, what
bounds it and what the design does about that) is its own shared library
with plain C entry points, built by :mod:`.build` at first use.  Nothing is
built or loaded when this module is imported.

The wrapper takes CUDA tensors only; :func:`repro_torch.kernels.ops.ssd`
dispatches CPU tensors to the plain version
(:func:`repro_torch.kernels.ref.ssd_chunked`).  ``ssd_launches`` counts its
calls; each launches two kernels (the chunks' Gram matrices C·Bᵀ into
scratch the wrapper allocates, then the heads).
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_tensor, load, raise_on

__all__ = ["MAX_SMEM_BYTES", "ssd_launches", "ssd_scan"]

MAX_SMEM_BYTES = 232_448  # shared memory one block of an H100 can use (227 KB)

ssd_launches = 0  # calls of ssd_scan that launched the kernels


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 7 + [i64, i64, i32, i32, i32, i32, i32, ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.ssd_scan_smem_bytes.restype = i64


def ssd_scan(
    x: torch.Tensor,  # [B, L, H, P] f32 or bf16 CUDA
    dt: torch.Tensor,  # [B, L, H] f32 CUDA, softplus-activated
    A: torch.Tensor,  # [H] f32 CUDA, negative decay rates
    Bm: torch.Tensor,  # [B, L, N] f32 CUDA
    Cm: torch.Tensor,  # [B, L, N] f32 CUDA
    chunk: int = 128,
) -> torch.Tensor:
    """Launch the SSD chunked scan on the current stream; returns ``y [B, L,
    H, P]`` in x's dtype with the semantics of
    :func:`repro_torch.kernels.ref.ssd_chunked` at ``min(chunk, L)``.  The
    caller pads L to a chunk multiple.  Does not synchronize."""
    global ssd_launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_tensor("x", x, x.dtype, 4)
    check_tensor("dt", dt, torch.float32, 3)
    check_tensor("A", A, torch.float32, 1)
    check_tensor("Bm", Bm, torch.float32, 3)
    check_tensor("Cm", Cm, torch.float32, 3)
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, L, H) or A.shape != (H,) or Bm.shape != (B, L, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not agree"
        )
    if any(a.device != x.device for a in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm and Cm must lie on one device")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    chunk = min(int(chunk), L)
    if chunk <= 0 or L % chunk:
        raise ValueError(f"L={L} must be a multiple of chunk={chunk}: pad the sequence")
    lib = load("ssd_scan", _bind)
    smem = lib.ssd_scan_smem_bytes(P, N, chunk, x.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"P={P}, N={N}, chunk={chunk}, {x.dtype} x need {smem} B of shared memory per block, "
            f"over the {MAX_SMEM_BYTES} B a block can use"
        )
    gram = torch.empty(B * L * chunk, dtype=torch.float32, device=x.device)  # [B, L/c, c, c]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), gram.data_ptr(), B, L, H, P, N, chunk,
            int(x.dtype == torch.bfloat16), stream,
        )
    raise_on(rc, "ssd_scan", lib, "ssd_scan")
    ssd_launches += 1
    return y
