"""Binding and wrapper of the hand-written expansion kernel.

``csrc/expand_events.cu`` (its header says why it exists, what bounds it
and what the design does about that) writes the analyzer's padded ``[B,
N]`` event planes on the card from the compact staging's flat columns
(:meth:`repro_torch.core.events.EventStager.stage_compact`).  It is its own
shared library with plain C entry points, built by :mod:`.build` at first
use; nothing is built or loaded when this module is imported.

The wrapper takes CUDA tensors only;
:func:`repro_torch.kernels.ops.expand_events` dispatches CPU tensors to the
plain version (:func:`repro_torch.kernels.ref.expand_events`).
``expand_launches`` counts its launches, one a call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..annotations import axes
from .build import check_tensor, load, raise_on
from .ref import check_expand_rows

__all__ = ["expand_events", "expand_launches"]

expand_launches = 0  # kernel launches made by expand_events


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.expand_events_launch.argtypes = [ptr] * 14 + [i64, i64, ptr]
    lib.expand_events_launch.restype = i32


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


@axes("E", offsets="R", pool="E", nbytes="E", weight="E", host="E", qos="E")
def expand_events(
    t: torch.Tensor,  # [E] f32 CUDA, the rows' events in row order
    offsets: torch.Tensor,  # [B + 1] i32 CUDA, row r's events at offsets[r]:offsets[r + 1]
    pool: torch.Tensor,  # [E] i32 CUDA
    nbytes: torch.Tensor,  # [E] f32 CUDA
    weight: torch.Tensor,  # [E] f32 CUDA
    host: Optional[torch.Tensor],  # [E] i32 CUDA, or None: no host plane
    qos: Optional[torch.Tensor],  # [E] i32 CUDA, or None: no qos plane
    n_bucket: int,  # the planes' row length
    longest: int,  # the longest row's events, as the caller's host offsets give it
) -> Tuple[Optional[torch.Tensor], ...]:
    """Launch the expansion on the current stream; returns ``(t, pool,
    bytes, weight, host, qos, valid)``, each ``[B, n_bucket]`` (host and
    qos None when not given), with the semantics of
    :func:`repro_torch.kernels.ref.expand_events`: ``longest`` above
    ``n_bucket`` raises before the launch.  The offsets, and ``longest``
    with them, are the caller's to keep consistent: the kernel reads the
    offsets on the card and writes no row past ``n_bucket``.  Does not
    synchronize."""
    global expand_launches
    check_expand_rows(longest, n_bucket)
    cols = {"t": (t, torch.float32), "pool": (pool, torch.int32),
            "nbytes": (nbytes, torch.float32), "weight": (weight, torch.float32),
            "host": (host, torch.int32), "qos": (qos, torch.int32)}
    check_tensor("offsets", offsets, torch.int32, 1)
    for name, (x, dtype) in cols.items():
        if x is None:
            continue
        check_tensor(name, x, dtype, 1)
        if x.shape != t.shape or x.device != offsets.device:
            raise ValueError(
                f"{name} {tuple(x.shape)} on {x.device}: the columns share t's shape "
                f"{tuple(t.shape)} and the offsets' device {offsets.device}"
            )
    n_rows, n = int(offsets.shape[0]) - 1, int(n_bucket)
    if n_rows < 0 or n < 1:
        raise ValueError(f"no planes of [{n_rows}, {n}]")

    def plane(x: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
        return None if x is None else torch.empty((n_rows, n), dtype=dtype, device=t.device)

    out = tuple(plane(x, dtype) for x, dtype in cols.values())
    valid = torch.empty((n_rows, n), dtype=torch.bool, device=t.device)
    lib = load("expand_events", _bind)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.expand_events_launch(
            offsets.data_ptr(), *(_ptr(x) for x, _ in cols.values()),
            *(_ptr(x) for x in out), valid.data_ptr(), n_rows, n, stream,
        )
    raise_on(rc, "expand_events", lib, "expand_events")
    expand_launches += 1
    return out + (valid,)
