"""Build and load the hand-written Hopper kernels.

Each CUDA C++ source under ``csrc/`` is its own shared library with plain C
entry points.  A library is compiled at first use by ``nvcc`` for
``sm_90a``, cached under ``build/repro_torch_kernels/`` at the repository
root by a hash of its source, the headers beside it and the flags, and
loaded with ``ctypes``; :func:`build_all` runs one ``nvcc`` per source at
once.  Nothing is built or loaded when this module is imported.
``nvcc_runs`` and ``library_loads`` count, for the whole process, the
``nvcc`` runs made and the libraries loaded: a steady-state scope makes
neither (:class:`~repro_torch.analysis.sanitize.RecompileSanitizer` reads
``nvcc_runs``).  Nothing but this module runs ``nvcc`` or loads a library
(the ``build-bypass`` rule of :mod:`repro_torch.analysis.dispatch`).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

import torch

__all__ = [
    "BuildResult", "SOURCES", "build", "build_all", "check_tensor", "library_loads", "load",
    "nvcc_runs", "raise_on",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "congestion_cascade": CSRC / "congestion_cascade.cu",
    "congestion_scan": CSRC / "congestion_scan.cu",
    "qos_cascade": CSRC / "qos_cascade.cu",
    "ssd_scan": CSRC / "ssd_scan.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "expand_events": CSRC / "expand_events.cu",
}
HEADERS = (CSRC / "cluster_cascade.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register / shared-memory / spill report in the build log
)

_libs: Dict[str, ctypes.CDLL] = {}
nvcc_runs = 0  # nvcc processes run by build(), this process
library_loads = 0  # libraries loaded by load(), this process
_count_lock = threading.Lock()  # build_all's threads count together


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
        "kernels are built from source at first use"
    )


def build(name: str = "congestion_cascade") -> BuildResult:
    """Compile library ``name`` (a key of :data:`SOURCES`) if no library of
    these sources and flags exists yet; raises with nvcc's output when
    compilation fails."""
    global nvcc_runs
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
    with _count_lock:
        nvcc_runs += 1
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


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Library ``name``, built and loaded once; ``bind`` declares its entry
    points' argument types.  Every library exports
    ``<name>_error_string(int)``."""
    global library_loads
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        with _count_lock:
            library_loads += 1
        bind(lib)
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def raise_on(rc: int, name: str, lib: ctypes.CDLL, what: str) -> None:
    """Raise when a launch entry point returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """A kernel operand: a contiguous CUDA tensor of ``dtype`` and ``ndim``
    dimensions, or raise."""
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
