"""Public kernel entry points, dispatched by the device of their input.

A CPU tensor runs the plain PyTorch version (:mod:`.ref`); a CUDA tensor
runs the hand-written kernel or raises.  There is no fallback from one to
the other.  ``plain_launches`` counts the plain path's calls here, cascades,
chain cascade, queue, SSD scan and attention alike; the kernel path counts its launches
in :mod:`repro_torch.kernels.congestion` (``launches``, ``hosts_launches``,
``scan_launches``, ``qos_launches``, ``qos_hosts_launches``),
:mod:`repro_torch.kernels.ssd_scan` (``ssd_launches``) and
:mod:`repro_torch.kernels.flash_attention` (``flash_launches``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..annotations import axes
from . import congestion as _kernel
from . import flash_attention as _flash
from . import ref
from . import ssd_scan as _ssd

__all__ = [
    "attention",
    "chain_cascade",
    "congestion_cascade",
    "congestion_queue",
    "plain_launches",
    "qos_congestion_cascade",
    "ssd",
]

plain_launches = 0  # calls of this module's entry points that ran the plain version


def _refuse_backward(name: str, backward: str, *tensors: torch.Tensor) -> None:
    """A kernel's output has no ``grad_fn``: with autograd recording and an
    input that requires grad, a backward pass through it would give zero
    gradients upstream without a word.  The plain versions (CPU tensors)
    stay differentiable through autograd, as the reference's are through
    ``jax.grad``; on the card there is no backward kernel, and no plain
    backward runs in its place."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} on {tensors[0].device.type} tensors that require grad: {backward} is "
            "not ported (the reference defines no backward kernel either); train on the "
            "CPU, or run this call under torch.no_grad() / torch.inference_mode()"
        )


@axes("B,N", bits="B,N", stts="S", hosts="B,N")
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


@axes("B,W", idx_pack="B,W")
def chain_cascade(
    t_pack: torch.Tensor,  # [B, W] f32 per-stage packed sorted runs (+inf pads)
    idx_pack: torch.Tensor,  # [B, W] i32 positions in the staged row (-1 pads)
    stts: Sequence[float],  # [D] service times in stage order (f32 values), on the host
    seg_caps: Sequence[int],  # per-stage segment widths, sum == W
):
    """The device-resident pipeline's compact suffix cascade on chain
    topologies; returns ``(t_fin [B, W], idx [B, W], per_stage_delay [B,
    D])``; see :func:`repro_torch.kernels.ref.chain_cascade`.  The merges
    are plain torch ops on every device (the reference never had a kernel
    for them); on the card each stage's scan is the scan kernel
    (``csrc/congestion_scan.cu``) over ``mask = idx >= 0``, so a batch
    launches it once per stage."""
    global plain_launches
    if t_pack.device.type == "cpu":
        plain_launches += 1
        return ref.chain_cascade(t_pack, idx_pack, stts, seg_caps)
    if t_pack.device.type == "cuda":
        return ref.chain_cascade(
            t_pack, idx_pack, stts, seg_caps, scan=_kernel.congestion_scan
        )
    raise ValueError(f"no chain_cascade for tensors on {t_pack.device}")


@axes("B,N", mask="B,N")
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


@axes(
    "B,N", bits="B,N", stts="S", qos="B,N", disc_code="S", class_weights="S,C",
    hosts="B,N",
)
def qos_congestion_cascade(
    t: torch.Tensor,  # [B, N] f32, each row time-sorted
    bits: torch.Tensor,  # [B, N] i32 route words
    stts: torch.Tensor,  # [S] f32 service times in stage order
    qos: torch.Tensor,  # [B, N] i32 QoS classes, same order as t
    disc_code: torch.Tensor,  # [S] i32 discipline codes (ref.DISC_*)
    class_weights: torch.Tensor,  # [S, C] f32 per-stage class weights
    hosts: Optional[torch.Tensor] = None,  # [B, N] i32 host ids, same order as t
    n_hosts: int = 1,
):
    """QoS-arbitrated cascade (priority / WFQ / FIFO per stage) over a batch
    of time-sorted epochs; returns ``(t_final [B, N], slot_idx [B, N],
    per_stage_delay [B, S, H, C])`` with ``H = n_hosts`` (1 without
    ``hosts``); see :func:`repro_torch.kernels.ref.qos_cascade_dyn`.  On the
    card the single-host kernel runs, or with ``hosts`` the host-segmented
    one."""
    global plain_launches
    if t.device.type == "cpu":
        plain_launches += 1
        return ref.qos_cascade_dyn(
            t, bits, stts, qos, disc_code, class_weights, hosts=hosts, n_hosts=n_hosts
        )
    if t.device.type == "cuda":
        if hosts is None:
            return _kernel.qos_congestion_cascade(t, bits, qos, stts, disc_code, class_weights)
        return _kernel.qos_congestion_cascade_hosts(
            t, bits, qos, hosts, stts, disc_code, class_weights, n_hosts
        )
    raise ValueError(f"no qos_congestion_cascade for tensors on {t.device}")


@axes("B,L,H,P", dt="B,L,H", A="H", Bm="B,L,N", Cm="B,L,N")
def ssd(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] f32, softplus-activated
    A: torch.Tensor,  # [H] f32, negative
    Bm: torch.Tensor,  # [B, L, N] f32
    Cm: torch.Tensor,  # [B, L, N] f32
    chunk: int = 128,
) -> torch.Tensor:
    """Mamba2 SSD mixer: ``x [B, L, H, P] -> y [B, L, H, P]`` in x's dtype,
    at chunk ``min(chunk, L)`` (L a multiple of it); see
    :func:`repro_torch.kernels.ref.ssd_chunked`.  Off the CPU an input that
    requires grad, with grad enabled, raises ``NotImplementedError``
    (:func:`_refuse_backward`)."""
    global plain_launches
    if x.device.type == "cpu":
        plain_launches += 1
        return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1]))
    _refuse_backward("ops.ssd", "the SSD backward kernel (an autograd.Function around "
                     "ssd_scan.cu)", x, dt, A, Bm, Cm)
    if x.device.type == "cuda":
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"no ssd for tensors on {x.device}")


@axes("B,H,Sq,D", k="B,Hk,Sk,D", v="B,Hk,Sk,D")
def attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hk, Sk, D]
    v: torch.Tensor,  # [B, Hk, Sk, D]
    q_offset: int = 0,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention: ``q [B, H, Sq, D]`` x ``k, v [B, Hk, Sk, D] -> [B, H,
    Sq, D]`` in q's dtype, causal on absolute positions (q[0] at
    ``q_offset``); see :func:`repro_torch.kernels.ref.mha_attention`.  The
    kernel picks its own tiles: the reference's ``block_q`` / ``block_k``
    were the TPU kernel's.  Off the CPU an input that requires grad, with
    grad enabled, raises ``NotImplementedError`` (:func:`_refuse_backward`)."""
    global plain_launches
    if q.device.type == "cpu":
        plain_launches += 1
        return ref.mha_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
    _refuse_backward("ops.attention", "the flash attention backward kernel", q, k, v)
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, q_offset=q_offset, causal=causal, scale=scale)
    raise ValueError(f"no attention for tensors on {q.device}")
