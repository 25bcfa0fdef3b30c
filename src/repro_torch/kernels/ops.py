"""Public kernel entry points, dispatched by the device of their input.

A CPU tensor runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor
runs the hand-written kernel or raises.  There is no fallback from one to
the other.  ``plain_launches`` counts the plain path's calls here, cascade
and queue alike; the kernel path counts its launches in
:mod:`repro_torch.kernels.congestion` (``launches``, ``hosts_launches``,
``scan_launches``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import congestion as _kernel
from . import ref

__all__ = ["congestion_cascade", "congestion_queue", "plain_launches"]

plain_launches = 0  # congestion_cascade / congestion_queue calls that ran the plain version


def congestion_cascade(
    t: torch.Tensor,  # [B, N] f32, each row time-sorted
    bits: torch.Tensor,  # [B, N] i32 route words
    stts: torch.Tensor,  # [S] f32 service times in stage order
    merge_plan: Optional[Sequence] = None,
    hosts: Optional[torch.Tensor] = None,  # [B, N] i32 host ids, same order as t
    n_hosts: int = 1,
):
    """Fused S-stage congestion cascade over a batch of time-sorted epochs.

    Returns ``(t_final [B, N], slot_idx [B, N], per_stage_delay [B, S])``,
    or ``[B, S, n_hosts]`` delays with ``hosts``; see
    :func:`repro_torch.kernels.ref.serial_queue_cascade`.  ``merge_plan``
    (from :func:`repro_torch.core.analyzer.plan_cascade`) prunes merges on
    the CPU path only: the kernels always run the conservative schedule, as
    the TPU kernels did, so callers gather their payloads through
    ``slot_idx`` whatever the device.
    """
    global plain_launches
    if t.device.type == "cpu":
        plain_launches += 1
        return ref.serial_queue_cascade(
            t, bits, stts, merge_plan, hosts=hosts, n_hosts=n_hosts
        )
    if t.device.type == "cuda":
        if hosts is None:
            return _kernel.congestion_cascade(t, bits, stts)
        return _kernel.congestion_cascade_hosts(t, bits, hosts, stts, n_hosts)
    raise ValueError(f"no congestion_cascade for tensors on {t.device}")


def congestion_queue(
    t: torch.Tensor,  # [B, N] f32, each row time-sorted
    mask: torch.Tensor,  # [B, N] bool, the events crossing this switch
    stt: float,  # service time, ns
):
    """One switch's serial-queue scan over a batch of rows; returns
    ``(start [B, N], delay [B, N])``; see
    :func:`repro_torch.kernels.ref.congestion_scan`."""
    global plain_launches
    if t.device.type == "cpu":
        plain_launches += 1
        return ref.congestion_scan(t, mask, stt)
    if t.device.type == "cuda":
        return _kernel.congestion_scan(t, mask, stt)
    raise ValueError(f"no congestion_queue for tensors on {t.device}")
