"""Public kernel entry points, dispatched by the device of their input.

A CPU tensor runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor
runs the hand-written kernel or raises.  There is no fallback from one to
the other.  ``plain_launches`` counts the plain path's calls here; the
kernel path counts its launches in :data:`repro_torch.kernels.congestion.launches`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import congestion as _kernel
from . import ref

__all__ = ["congestion_cascade", "plain_launches"]

plain_launches = 0  # congestion_cascade calls that ran the plain version


def congestion_cascade(
    t: torch.Tensor,  # [B, N] f32, each row time-sorted
    bits: torch.Tensor,  # [B, N] i32 route words
    stts: torch.Tensor,  # [S] f32 service times in stage order
    merge_plan: Optional[Sequence] = None,
):
    """Fused S-stage congestion cascade over a batch of time-sorted epochs.

    Returns ``(t_final [B, N], slot_idx [B, N], per_stage_delay [B, S])``;
    see :func:`repro_torch.kernels.ref.serial_queue_cascade`.
    ``merge_plan`` (from :func:`repro_torch.core.analyzer.plan_cascade`)
    prunes merges on the CPU path only: the kernel always runs the
    conservative schedule, as the TPU kernel did, so callers gather their
    payloads through ``slot_idx`` whatever the device.
    """
    global plain_launches
    if t.device.type == "cpu":
        plain_launches += 1
        return ref.serial_queue_cascade(t, bits, stts, merge_plan)
    if t.device.type == "cuda":
        return _kernel.congestion_cascade(t, bits, stts)
    raise ValueError(f"no congestion_cascade for tensors on {t.device}")
