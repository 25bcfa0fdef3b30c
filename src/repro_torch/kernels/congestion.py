"""Bindings and wrappers of the hand-written Hopper congestion kernels.

Three CUDA C++ sources under ``csrc/``, each its own shared library with
plain C entry points (their headers say which TPU kernel each replaces, what
bounds it and what the design does about that):

- ``congestion_cascade.cu``: the fused S-stage cascade, single-host
  (:func:`congestion_cascade`) and host-segmented
  (:func:`congestion_cascade_hosts`), one template body;
- ``congestion_scan.cu``: one switch's masked FIFO scan
  (:func:`congestion_scan`), the unfused per-stage loop's kernel: a
  single-pass scan over tiles of ``ref.SCAN_TILE`` events with decoupled
  look-back;
- ``qos_cascade.cu``: the QoS-arbitrated cascade (priority / WFQ / FIFO per
  stage), single-host (:func:`qos_congestion_cascade`) and host-segmented
  (:func:`qos_congestion_cascade_hosts`), one template body.

The two cascades share ``csrc/cluster_cascade.cuh`` (a thread-block cluster
of :func:`ctas_per_row` CTAs per epoch row).  :mod:`.build` compiles each
library at first use (``build`` and ``build_all`` are re-exported here);
nothing is built or loaded when this module is imported.

The wrappers take CUDA tensors only; :mod:`.ops` dispatches CPU tensors to
the plain versions (:mod:`.ref`).  ``launches``, ``hosts_launches``,
``scan_launches``, ``qos_launches`` and ``qos_hosts_launches`` count the
launches each wrapper made; ``last_merge_flags`` holds the ``[B, S]`` int8
merge flags (``ref.MERGE_*``) of the last cascade launch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..annotations import axes
from . import ref
from .build import SOURCES, BuildResult, build, build_all, check_tensor, load, raise_on
from .build import _libs  # noqa: F401  (the loaded libraries)

__all__ = [
    "BuildResult",
    "SOURCES",
    "build",
    "build_all",
    "congestion_cascade",
    "congestion_cascade_hosts",
    "congestion_scan",
    "ctas_per_row",
    "hosts_launches",
    "last_merge_flags",
    "launches",
    "qos_congestion_cascade",
    "qos_congestion_cascade_hosts",
    "qos_hosts_launches",
    "qos_launches",
    "scan_launches",
]

MAX_STAGES = 31  # stage s is bit s of an int32 route word
MAX_HOSTS = 32  # per-host delay slots of the hosts kernels
MAX_CLASSES = 8  # QoS classes of the QoS kernel (kMaxClasses)
MAX_CTAS = 8  # CTAs per row: the portable cluster size (kMaxCtas)

launches = 0  # kernel launches made by congestion_cascade
hosts_launches = 0  # kernel launches made by congestion_cascade_hosts
scan_launches = 0  # kernel launches made by congestion_scan
qos_launches = 0  # kernel launches made by qos_congestion_cascade
qos_hosts_launches = 0  # kernel launches made by qos_congestion_cascade_hosts
last_merge_flags = None  # [B, S] int8 merge flags of the last cascade launch


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _bind_cascade(lib: ctypes.CDLL) -> None:
    lib.congestion_cascade_launch.argtypes = [_PTR] * 8 + [_I64, _I64, _I32, _I32, _PTR]
    lib.congestion_cascade_launch.restype = _I32
    lib.congestion_cascade_hosts_launch.argtypes = [_PTR] * 9 + [
        _I64, _I64, _I32, _I32, _I32, _PTR,
    ]
    lib.congestion_cascade_hosts_launch.restype = _I32


def _bind_scan(lib: ctypes.CDLL) -> None:
    lib.congestion_scan_launch.argtypes = [
        _PTR, _PTR, ctypes.c_float, _PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR,
    ]
    lib.congestion_scan_launch.restype = _I32


def _bind_qos(lib: ctypes.CDLL) -> None:
    lib.qos_cascade_launch.argtypes = [_PTR] * 11 + [_I64, _I64, _I32, _I32, _I32, _PTR]
    lib.qos_cascade_launch.restype = _I32
    lib.qos_cascade_hosts_launch.argtypes = [_PTR] * 12 + [
        _I64, _I64, _I32, _I32, _I32, _I32, _PTR,
    ]
    lib.qos_cascade_hosts_launch.restype = _I32


def ctas_per_row(n_rows: int, n: int, n_sms: int, tile: int = ref.KERNEL_TILE) -> int:
    """The CTAs a cascade kernel gives each epoch row (the cluster size):
    enough that ``n_rows`` clusters fill the card's ``n_sms`` SMs, at most
    ``MAX_CTAS`` (a portable cluster) and at most one per ``tile`` events
    of the row, and at least 1.  ``[32, 1048576]`` on 132 SMs takes 4 (128
    CTAs), a single ``[1, 1048576]`` row 8, and 132 rows or more 1."""
    k = min(n_sms // max(int(n_rows), 1), MAX_CTAS, -(-int(n) // tile))
    return max(1, k)


def _ctas(t: torch.Tensor) -> int:
    n_rows, n = t.shape
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return ctas_per_row(n_rows, n, sms)


def _cascade_inputs(t, bits, stts) -> Tuple[int, int, int]:
    check_tensor("t", t, torch.float32, 2)
    check_tensor("bits", bits, torch.int32, 2)
    check_tensor("stts", stts, torch.float32, 1)
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


def _scratch(t, planes: int):
    """The kernels' working state: ``planes`` 32-bit words per event."""
    return torch.empty((planes,) + tuple(t.shape), dtype=torch.int32, device=t.device)


def _flags(t, n_stages: int):
    global last_merge_flags
    last_merge_flags = torch.zeros((t.shape[0], n_stages), dtype=torch.int8, device=t.device)
    return last_merge_flags


@axes("B,N", bits="B,N", stts="S")
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
    scratch = _scratch(t, 4)
    flags = _flags(t, n_stages)
    lib = load("congestion_cascade", _bind_cascade)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.congestion_cascade_launch(
            t.data_ptr(), bits.data_ptr(), stts.data_ptr(), t_out.data_ptr(),
            idx.data_ptr(), scratch.data_ptr(), psd.data_ptr(), flags.data_ptr(),
            n_rows, n, n_stages, _ctas(t), stream,
        )
    raise_on(rc, "congestion_cascade", lib, "congestion_cascade")
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
    check_tensor("hosts", hosts, torch.int32, 2)
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
    scratch = _scratch(t, 4)
    flags = _flags(t, n_stages)
    lib = load("congestion_cascade", _bind_cascade)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.congestion_cascade_hosts_launch(
            t.data_ptr(), bits.data_ptr(), hosts.data_ptr(), stts.data_ptr(),
            t_out.data_ptr(), idx.data_ptr(), scratch.data_ptr(), psd.data_ptr(),
            flags.data_ptr(), n_rows, n, n_stages, n_hosts, _ctas(t), stream,
        )
    raise_on(rc, "congestion_cascade", lib, "congestion_cascade_hosts")
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
    check_tensor("t", t, torch.float32, 2)
    check_tensor("mask", mask, torch.bool, 2)
    if mask.shape != t.shape or mask.device != t.device:
        raise ValueError(
            f"mask {tuple(mask.shape)} on {mask.device} must match t "
            f"{tuple(t.shape)} on {t.device}"
        )
    n_rows, n = t.shape
    if n >= 2**31:
        raise ValueError(f"rows of {n} events exceed the kernel's int32 counts")
    start = torch.empty_like(t)
    delay = torch.empty_like(t)
    # the count and max status words of every tile, then the tile counter;
    # the launch zeroes them on the stream
    status = torch.empty(2 * n_rows * -(-n // ref.SCAN_TILE) + 1, dtype=torch.int64,
                         device=t.device)
    lib = load("congestion_scan", _bind_scan)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.congestion_scan_launch(
            t.data_ptr(), mask.data_ptr(), float(stt), start.data_ptr(),
            delay.data_ptr(), status.data_ptr(), status.numel(), n_rows, n, stream,
        )
    raise_on(rc, "congestion_scan", lib, "congestion_scan")
    scan_launches += 1
    return start, delay


def _qos_limits(class_weights: torch.Tensor, n_hosts: int) -> int:
    """The kernel's fixed limits, checked before anything else."""
    n_classes = int(class_weights.shape[-1])
    if not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(
            f"{n_classes} QoS classes: the QoS kernel takes 1 to "
            f"kMaxClasses={MAX_CLASSES}"
        )
    if not 1 <= n_hosts <= MAX_HOSTS:
        raise ValueError(f"n_hosts={n_hosts} outside [1, kMaxHosts={MAX_HOSTS}]")
    return n_classes


def _qos_inputs(t, bits, qos, stts, disc_code, class_weights) -> Tuple[int, int, int]:
    n_rows, n, n_stages = _cascade_inputs(t, bits, stts)
    check_tensor("qos", qos, torch.int32, 2)
    check_tensor("disc_code", disc_code, torch.int32, 1)
    check_tensor("class_weights", class_weights, torch.float32, 2)
    if qos.shape != t.shape or qos.device != t.device:
        raise ValueError(
            f"qos {tuple(qos.shape)} on {qos.device} must match t "
            f"{tuple(t.shape)} on {t.device}"
        )
    if disc_code.device != t.device or class_weights.device != t.device:
        raise ValueError("disc_code and class_weights must lie on t's device")
    if disc_code.shape[0] != n_stages or class_weights.shape[0] != n_stages:
        raise ValueError(
            f"disc_code {tuple(disc_code.shape)} and class_weights "
            f"{tuple(class_weights.shape)} must give one row per stage ({n_stages})"
        )
    return n_rows, n, n_stages


def _qos_launch(t, bits, qos, hosts, stts, disc_code, class_weights, n_hosts):
    n_classes = _qos_limits(class_weights, n_hosts)
    n_rows, n, n_stages = _qos_inputs(t, bits, qos, stts, disc_code, class_weights)
    table = ref.qos_service_table(stts, disc_code, class_weights)
    t_out = torch.empty_like(t)
    idx = torch.empty_like(bits)
    psd = torch.empty(
        (n_rows, n_stages, n_hosts, n_classes), dtype=torch.float32, device=t.device
    )
    scratch = _scratch(t, 10)
    flags = _flags(t, n_stages)
    lib = load("qos_cascade", _bind_qos)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        common = (
            stts.data_ptr(), table.data_ptr(), disc_code.data_ptr(), t_out.data_ptr(),
            idx.data_ptr(), scratch.data_ptr(), psd.data_ptr(), flags.data_ptr(), n_rows, n,
            n_stages, n_classes,
        )
        if hosts is None:
            rc = lib.qos_cascade_launch(
                t.data_ptr(), bits.data_ptr(), qos.data_ptr(), *common, _ctas(t), stream
            )
        else:
            rc = lib.qos_cascade_hosts_launch(
                t.data_ptr(), bits.data_ptr(), qos.data_ptr(), hosts.data_ptr(), *common,
                n_hosts, _ctas(t), stream,
            )
    raise_on(rc, "qos_cascade", lib,
              "qos_congestion_cascade" + ("" if hosts is None else "_hosts"))
    return t_out, idx, psd


@axes("B,N", bits="B,N", qos="B,N", stts="S", disc_code="S", class_weights="S,C")
def qos_congestion_cascade(
    t: torch.Tensor,  # [B, N] f32 CUDA, each row time-sorted (pads: finfo.max/4)
    bits: torch.Tensor,  # [B, N] i32 CUDA route words
    qos: torch.Tensor,  # [B, N] i32 CUDA QoS classes, same order as t
    stts: torch.Tensor,  # [S] f32 CUDA, service times in stage order
    disc_code: torch.Tensor,  # [S] i32 CUDA discipline codes (ref.DISC_*)
    class_weights: torch.Tensor,  # [S, C] f32 CUDA per-stage class weights
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the QoS cascade on the current stream; returns ``(t_final
    [B, N] f32, slot_idx [B, N] i32, per_stage_delay [B, S, 1, C] f32)`` with
    the semantics of :func:`repro_torch.kernels.ref.qos_cascade_dyn`.
    Classes outside ``[0, C)`` are clipped.  Does not synchronize."""
    global qos_launches
    out = _qos_launch(t, bits, qos, None, stts, disc_code, class_weights, 1)
    qos_launches += 1
    return out


def qos_congestion_cascade_hosts(
    t: torch.Tensor,  # [B, N] f32 CUDA, each row time-sorted (pads: finfo.max/4)
    bits: torch.Tensor,  # [B, N] i32 CUDA route words
    qos: torch.Tensor,  # [B, N] i32 CUDA QoS classes, same order as t
    hosts: torch.Tensor,  # [B, N] i32 CUDA host ids in [0, n_hosts), same order as t
    stts: torch.Tensor,  # [S] f32 CUDA, service times in stage order
    disc_code: torch.Tensor,  # [S] i32 CUDA discipline codes (ref.DISC_*)
    class_weights: torch.Tensor,  # [S, C] f32 CUDA per-stage class weights
    n_hosts: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the host-segmented QoS cascade on the current stream; returns
    ``(t_final [B, N] f32, slot_idx [B, N] i32, per_stage_delay [B, S,
    n_hosts, C] f32)`` with the semantics of
    :func:`repro_torch.kernels.ref.qos_cascade_dyn` with ``hosts``.  Host
    ids outside ``[0, n_hosts)`` are charged to no host.  Does not
    synchronize."""
    global qos_hosts_launches
    n_hosts = int(n_hosts)
    _qos_limits(class_weights, n_hosts)
    check_tensor("hosts", hosts, torch.int32, 2)
    if hosts.shape != t.shape or hosts.device != t.device:
        raise ValueError(
            f"hosts {tuple(hosts.shape)} on {hosts.device} must match t "
            f"{tuple(t.shape)} on {t.device}"
        )
    out = _qos_launch(t, bits, qos, hosts, stts, disc_code, class_weights, n_hosts)
    qos_hosts_launches += 1
    return out
