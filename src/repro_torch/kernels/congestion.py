"""Build, binding and wrapper of the hand-written Hopper congestion cascade.

The CUDA C++ source is ``csrc/congestion_cascade.cu`` (it replaces the TPU
kernel ``repro/kernels/congestion.py:congestion_cascade``; the source's
header says what bounds it and what its design does about that).  It is
compiled at first use by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C entry point, cached under ``build/repro_torch_kernels/`` at the
repository root by a hash of the source and flags, and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

:func:`congestion_cascade` takes CUDA tensors only; :mod:`.ops` dispatches
CPU tensors to the plain version (:mod:`.ref`).  ``launches`` counts the
kernel launches this wrapper made.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

__all__ = ["BuildResult", "SOURCE", "build", "congestion_cascade", "launches"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "congestion_cascade.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register / shared-memory / spill report in the build log
)
MAX_STAGES = 31  # stage s is bit s of an int32 route word

launches = 0  # kernel launches made by congestion_cascade

_lib: Optional[ctypes.CDLL] = None


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path  # the shared library
    seconds: float  # nvcc wall time (0 when the cached library was reused)
    log: str  # nvcc's output (ptxas resource report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): the "
        "congestion cascade kernel is built from source at first use"
    )


def build() -> BuildResult:
    """Compile the kernel library if no library of this source and these
    flags exists yet; raises with nvcc's output when compilation fails."""
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"congestion_cascade_{tag}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a torn file
    return BuildResult(out, seconds, log)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        ptr = ctypes.c_void_p
        lib.congestion_cascade_launch.argtypes = [ptr] * 10 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ptr,
        ]
        lib.congestion_cascade_launch.restype = ctypes.c_int
        lib.congestion_cascade_error_string.argtypes = [ctypes.c_int]
        lib.congestion_cascade_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"{name} lies on {x.device}: the CUDA kernel takes CUDA tensors "
            "(repro_torch.kernels.ops dispatches CPU tensors to the plain version)"
        )
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def congestion_cascade(
    t: torch.Tensor,  # [B, N] f32 CUDA, each row time-sorted (pads: finfo.max/4)
    bits: torch.Tensor,  # [B, N] i32 CUDA, bit s set iff the event crosses stage s
    stts: torch.Tensor,  # [S] f32 CUDA, service times in stage order
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused cascade on the current stream; returns ``(t_final
    [B, N] f32, slot_idx [B, N] i32, per_stage_delay [B, S] f32)`` with the
    semantics of :func:`repro_torch.kernels.ref.serial_queue_cascade` under
    ``merge_plan=None``.  Does not synchronize."""
    global launches
    _check("t", t, torch.float32, 2)
    _check("bits", bits, torch.int32, 2)
    _check("stts", stts, torch.float32, 1)
    if bits.shape != t.shape:
        raise ValueError(f"bits shape {tuple(bits.shape)} != t shape {tuple(t.shape)}")
    if bits.device != t.device or stts.device != t.device:
        raise ValueError("t, bits and stts must lie on one device")
    n_rows, n = t.shape
    n_stages = int(stts.shape[0])
    if n_stages > MAX_STAGES:
        raise ValueError(f"{n_stages} stages exceed the {MAX_STAGES}-bit route word")
    if n >= 2**31:
        raise ValueError(f"rows of {n} events exceed the kernel's int32 slot index")
    t_out = torch.empty_like(t)
    idx = torch.empty_like(bits)
    psd = torch.empty((n_rows, n_stages), dtype=torch.float32, device=t.device)
    # scratch: the working route bits and the merge's compacted runs
    bits_work = torch.empty_like(bits)
    comp_t = torch.empty_like(t)
    comp_bits = torch.empty_like(bits)
    comp_idx = torch.empty_like(bits)
    lib = _load()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.congestion_cascade_launch(
            t.data_ptr(), bits.data_ptr(), stts.data_ptr(), t_out.data_ptr(),
            idx.data_ptr(), bits_work.data_ptr(), comp_t.data_ptr(),
            comp_bits.data_ptr(), comp_idx.data_ptr(), psd.data_ptr(),
            n_rows, n, n_stages, stream,
        )
    if rc != 0:
        msg = lib.congestion_cascade_error_string(rc).decode()
        raise RuntimeError(f"congestion_cascade launch failed: CUDA error {rc} ({msg})")
    launches += 1
    return t_out, idx, psd
