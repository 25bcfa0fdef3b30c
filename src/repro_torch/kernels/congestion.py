"""Build, binding and wrappers of the hand-written Hopper congestion kernels.

Two CUDA C++ sources under ``csrc/``, each its own shared library with plain
C entry points (their headers say which TPU kernel each replaces, what
bounds it and what the design does about that):

- ``congestion_cascade.cu``: the fused S-stage cascade, single-host
  (:func:`congestion_cascade`) and host-segmented
  (:func:`congestion_cascade_hosts`), one template body;
- ``congestion_scan.cu``: one switch's masked FIFO scan
  (:func:`congestion_scan`), the unfused per-stage loop's kernel.

Both include ``csrc/block_scan.cuh``.  Each library is compiled at first use
by ``nvcc`` for ``sm_90a``, cached under ``build/repro_torch_kernels/`` at the
repository root by a hash of its sources and flags, and loaded with
``ctypes``; :func:`build_all` runs one ``nvcc`` per source at once.  Nothing
is built or loaded when this module is imported.

The wrappers take CUDA tensors only; :mod:`.ops` dispatches CPU tensors to
the plain versions (:mod:`.ref`).  ``launches``, ``hosts_launches`` and
``scan_launches`` count the launches each wrapper made.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

__all__ = [
    "BuildResult",
    "SOURCES",
    "build",
    "build_all",
    "congestion_cascade",
    "congestion_cascade_hosts",
    "congestion_scan",
    "hosts_launches",
    "launches",
    "scan_launches",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "congestion_cascade": CSRC / "congestion_cascade.cu",
    "congestion_scan": CSRC / "congestion_scan.cu",
}
HEADERS = (CSRC / "block_scan.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register / shared-memory / spill report in the build log
)
MAX_STAGES = 31  # stage s is bit s of an int32 route word
MAX_HOSTS = 32  # per-host delay slots of the hosts kernel

launches = 0  # kernel launches made by congestion_cascade
hosts_launches = 0  # kernel launches made by congestion_cascade_hosts
scan_launches = 0  # kernel launches made by congestion_scan

_libs: Dict[str, ctypes.CDLL] = {}


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
        "congestion kernels are built from source at first use"
    )


def build(name: str = "congestion_cascade") -> BuildResult:
    """Compile library ``name`` (a key of :data:`SOURCES`) if no library of
    these sources and flags exists yet; raises with nvcc's output when
    compilation fails."""
    source = SOURCES[name]
    digest = hashlib.sha256(source.read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
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


def build_all() -> Dict[str, BuildResult]:
    """Build every library, one ``nvcc`` per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "congestion_cascade":
            lib.congestion_cascade_launch.argtypes = [ptr] * 10 + [i64, i64, i32, ptr]
            lib.congestion_cascade_launch.restype = i32
            lib.congestion_cascade_hosts_launch.argtypes = [ptr] * 11 + [
                i64, i64, i32, i32, ptr,
            ]
            lib.congestion_cascade_hosts_launch.restype = i32
        else:
            lib.congestion_scan_launch.argtypes = [
                ptr, ptr, ctypes.c_float, ptr, ptr, i64, i64, ptr,
            ]
            lib.congestion_scan_launch.restype = i32
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _raise_on(rc: int, name: str, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


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


def _cascade_inputs(t, bits, stts) -> Tuple[int, int, int]:
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
    return n_rows, n, n_stages


def _cascade_scratch(t, bits):
    """The working route bits and the merge's compacted runs."""
    return (torch.empty_like(bits), torch.empty_like(t), torch.empty_like(bits),
            torch.empty_like(bits))


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
    n_rows, n, n_stages = _cascade_inputs(t, bits, stts)
    t_out = torch.empty_like(t)
    idx = torch.empty_like(bits)
    psd = torch.empty((n_rows, n_stages), dtype=torch.float32, device=t.device)
    bits_work, comp_t, comp_bits, comp_idx = _cascade_scratch(t, bits)
    lib = _load("congestion_cascade")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.congestion_cascade_launch(
            t.data_ptr(), bits.data_ptr(), stts.data_ptr(), t_out.data_ptr(),
            idx.data_ptr(), bits_work.data_ptr(), comp_t.data_ptr(),
            comp_bits.data_ptr(), comp_idx.data_ptr(), psd.data_ptr(),
            n_rows, n, n_stages, stream,
        )
    _raise_on(rc, "congestion_cascade", lib, "congestion_cascade")
    launches += 1
    return t_out, idx, psd


def congestion_cascade_hosts(
    t: torch.Tensor,  # [B, N] f32 CUDA, each row time-sorted (pads: finfo.max/4)
    bits: torch.Tensor,  # [B, N] i32 CUDA route words
    hosts: torch.Tensor,  # [B, N] i32 CUDA host ids in [0, n_hosts), same order as t
    stts: torch.Tensor,  # [S] f32 CUDA, service times in stage order
    n_hosts: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the host-segmented cascade on the current stream; returns
    ``(t_final [B, N] f32, slot_idx [B, N] i32, per_stage_delay [B, S,
    n_hosts] f32)`` with the semantics of
    :func:`repro_torch.kernels.ref.serial_queue_cascade` with ``hosts``.
    Host ids outside ``[0, n_hosts)`` are charged to no host.  Does not
    synchronize."""
    global hosts_launches
    n_rows, n, n_stages = _cascade_inputs(t, bits, stts)
    _check("hosts", hosts, torch.int32, 2)
    if hosts.shape != t.shape or hosts.device != t.device:
        raise ValueError(
            f"hosts {tuple(hosts.shape)} on {hosts.device} must match t "
            f"{tuple(t.shape)} on {t.device}"
        )
    n_hosts = int(n_hosts)
    if not 1 <= n_hosts <= MAX_HOSTS:
        raise ValueError(f"n_hosts={n_hosts} outside [1, {MAX_HOSTS}]")
    t_out = torch.empty_like(t)
    idx = torch.empty_like(bits)
    psd = torch.empty((n_rows, n_stages, n_hosts), dtype=torch.float32, device=t.device)
    bits_work, comp_t, comp_bits, comp_idx = _cascade_scratch(t, bits)
    lib = _load("congestion_cascade")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.congestion_cascade_hosts_launch(
            t.data_ptr(), bits.data_ptr(), hosts.data_ptr(), stts.data_ptr(),
            t_out.data_ptr(), idx.data_ptr(), bits_work.data_ptr(),
            comp_t.data_ptr(), comp_bits.data_ptr(), comp_idx.data_ptr(),
            psd.data_ptr(), n_rows, n, n_stages, n_hosts, stream,
        )
    _raise_on(rc, "congestion_cascade", lib, "congestion_cascade_hosts")
    hosts_launches += 1
    return t_out, idx, psd


def congestion_scan(
    t: torch.Tensor,  # [B, N] f32 CUDA, each row time-sorted
    mask: torch.Tensor,  # [B, N] bool CUDA, the events crossing this switch
    stt: float,  # the switch's service time, ns
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one switch's masked FIFO scan on the current stream; returns
    ``(start [B, N] f32, delay [B, N] f32)`` with the semantics of
    :func:`repro_torch.kernels.ref.congestion_scan`.  Does not
    synchronize."""
    global scan_launches
    _check("t", t, torch.float32, 2)
    _check("mask", mask, torch.bool, 2)
    if mask.shape != t.shape or mask.device != t.device:
        raise ValueError(
            f"mask {tuple(mask.shape)} on {mask.device} must match t "
            f"{tuple(t.shape)} on {t.device}"
        )
    n_rows, n = t.shape
    start = torch.empty_like(t)
    delay = torch.empty_like(t)
    lib = _load("congestion_scan")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.congestion_scan_launch(
            t.data_ptr(), mask.data_ptr(), float(stt), start.data_ptr(),
            delay.data_ptr(), n_rows, n, stream,
        )
    _raise_on(rc, "congestion_scan", lib, "congestion_scan")
    scan_launches += 1
    return start, delay
