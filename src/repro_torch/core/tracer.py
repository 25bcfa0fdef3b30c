"""The Tracer (paper §3, component 1): port of ``repro/core/tracer.py``.

The paper traces (a) allocations via eBPF and (b) memory events via PEBS.
The simulator instead describes each step structurally:

  * **structural trace** — models describe each step as a list of
    :class:`Phase` objects (one per layer/sub-block) with logical
    :class:`Access` records (which region, how many bytes, read or write).
    This is the pool-attribution source, playing the role of the eBPF
    address-range map.
  * **pacing** — each phase's events are spread uniformly over its
    roofline-paced duration under a :class:`HardwareModel`.

The reference's HLO calibration helpers (``hlo_cost_summary``,
``calibration_factor``) read XLA objects and have no counterpart here; the
``calibration`` factor itself stays an argument.

Event batching: a logical access of B bytes at granule g becomes
``min(ceil(B/g), max_events)`` events carrying equal byte shares.  Aggregate
bytes are exact; only the event count is coalesced, which is the same fidelity
trade PEBS sampling makes.

Synthesis is split into two halves so scenario sweeps don't re-pay it:

  * :func:`synthesize_skeleton` builds the **placement-independent**
    structural skeleton — event times, byte shares, region ids, epoch
    boundaries — once, with array ops (``np.repeat`` expansion; no
    per-access Python loop over events).
  * :func:`skeleton_to_events` is the cheap per-scenario step: one gather
    of a ``[R]`` region→pool vector through the skeleton's region ids.

:func:`synthesize_step_trace` composes the two (bit-identical to the
reference's output, same event order).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .events import MemEvents, RegionMap
from .units import s_to_ns

__all__ = [
    "Access",
    "Phase",
    "HardwareModel",
    "H100_SXM",
    "TPU_V5E",
    "TraceSkeleton",
    "skeleton_to_events",
    "synthesize_skeleton",
    "synthesize_step_trace",
    "phase_duration_ns",
]


@dataclasses.dataclass(frozen=True)
class Access:
    """One logical tensor access inside a phase."""

    region: str
    bytes_: float
    is_write: bool = False


@dataclasses.dataclass(frozen=True)
class Phase:
    """One schedulable unit of a step (a layer, a collective, an update)."""

    name: str
    flops: float
    accesses: Tuple[Access, ...]

    def total_bytes(self) -> float:
        return sum(a.bytes_ for a in self.accesses)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Roofline constants used to pace issue times (and by §Roofline)."""

    name: str
    peak_flops: float  # FLOP/s (bf16 dense)
    hbm_gbps: float  # bytes/ns == GB/s
    ici_gbps: float  # per-link chip-to-chip bandwidth (ICI / NVLink)

    def phase_ns(self, flops: float, bytes_: float) -> float:
        """Roofline-paced duration: max of compute time and memory time."""
        t_c = s_to_ns(flops / self.peak_flops)
        t_m = bytes_ / self.hbm_gbps  # GB/s == bytes/ns
        return max(t_c, t_m, 1.0)


TPU_V5E = HardwareModel(
    name="tpu_v5e", peak_flops=197e12, hbm_gbps=819.0, ici_gbps=50.0
)

# NVIDIA H100 SXM data-sheet constants: 989 TFLOP/s dense bf16 tensor-core
# peak, 3.35 TB/s HBM3, 450 GB/s NVLink per direction (900 GB/s total).
# Pacing constants only — nothing here was measured.
H100_SXM = HardwareModel(
    name="h100_sxm", peak_flops=989e12, hbm_gbps=3350.0, ici_gbps=450.0
)


def phase_duration_ns(phase: Phase, hw: HardwareModel) -> float:
    return hw.phase_ns(phase.flops, phase.total_bytes())


@dataclasses.dataclass(frozen=True)
class TraceSkeleton:
    """Placement-independent half of a synthesized trace.

    Everything here is fixed once phases, hardware model, granule,
    calibration and epoch mode are fixed — only the per-event *pool*
    changes across placement scenarios, and that is a single gather of a
    region→pool vector through ``region`` (:func:`skeleton_to_events`).

    ``epoch_ptr[e]:epoch_ptr[e+1]`` delimits epoch ``e``'s events (one
    epoch in ``'step'`` mode, one per phase in ``'layer'`` mode); times are
    epoch-relative, exactly as the historical synthesis emitted them.
    """

    t_ns: np.ndarray  # [N] float64 epoch-relative issue times
    bytes_: np.ndarray  # [N] float64 byte share per event
    is_write: np.ndarray  # [N] bool
    region: np.ndarray  # [N] int32 region id
    epoch_ptr: np.ndarray  # [E+1] int64 event-index boundaries per epoch
    native_ns: Tuple[float, ...]  # [E] roofline-paced epoch durations
    epoch_names: Tuple[str, ...]  # [E]
    granularity_bytes: float

    @property
    def n(self) -> int:
        return int(len(self.t_ns))

    @property
    def n_epochs(self) -> int:
        return int(len(self.epoch_ptr) - 1)


def synthesize_skeleton(
    phases: Sequence[Phase],
    regions: RegionMap,
    hw: HardwareModel = TPU_V5E,
    granularity_bytes: float = 64.0,
    max_events_per_access: int = 64,
    calibration: float = 1.0,
    epoch_mode: str = "step",
) -> TraceSkeleton:
    """Build the structural skeleton with array ops (no per-event loop).

    The only Python iteration is over the phase/access *structure* (tens of
    entries); the expansion of each access into its event train — the part
    that scales with trace size — is one ``np.repeat`` + arange pass.
    """
    if epoch_mode not in ("step", "layer"):
        raise ValueError(epoch_mode)
    # structural pass: one row per logical access
    rid: List[int] = []
    acc_bytes: List[float] = []
    acc_write: List[bool] = []
    acc_phase: List[int] = []
    durations: List[float] = []
    counts: List[int] = []  # accesses per phase (for epoch_ptr)
    for pi, ph in enumerate(phases):
        durations.append(phase_duration_ns(ph, hw))
        counts.append(len(ph.accesses))
        for a in ph.accesses:
            if a.region not in regions:
                raise KeyError(f"phase {ph.name}: unknown region {a.region!r}")
            rid.append(regions[a.region].rid)
            acc_bytes.append(a.bytes_ * calibration)
            acc_write.append(a.is_write)
            acc_phase.append(pi)

    dur = np.asarray(durations, np.float64)
    names = tuple(ph.name for ph in phases)
    if not rid:
        empty_ptr = (
            np.zeros((len(phases) + 1,), np.int64)
            if epoch_mode == "layer"
            else np.zeros((2,), np.int64)
        )
        return TraceSkeleton(
            t_ns=np.zeros((0,), np.float64),
            bytes_=np.zeros((0,), np.float64),
            is_write=np.zeros((0,), bool),
            region=np.zeros((0,), np.int32),
            epoch_ptr=empty_ptr,
            native_ns=tuple(dur) if epoch_mode == "layer" else (float(dur.sum()),),
            epoch_names=names if epoch_mode == "layer" else ("step",),
            granularity_bytes=float(granularity_bytes),
        )

    b = np.asarray(acc_bytes, np.float64)
    a_phase = np.asarray(acc_phase, np.int64)
    n_ev = np.minimum(
        np.maximum(np.ceil(b / granularity_bytes), 1), max_events_per_access
    ).astype(np.int64)
    share = b / n_ev  # equal byte shares; aggregate bytes stay exact

    N = int(n_ev.sum())
    excl = np.concatenate([[0], np.cumsum(n_ev)])  # [A+1]
    # per-event index within its access train, via one global arange
    within = np.arange(N, dtype=np.float64) - np.repeat(excl[:-1], n_ev)
    n_ev_rep = np.repeat(n_ev.astype(np.float64), n_ev)
    dur_rep = np.repeat(dur[a_phase], n_ev)
    # deterministic uniform spread across the phase (no RNG: traces must be
    # reproducible for regression tests); same float ops as the historical
    # per-access loop, so outputs are bit-identical
    offs = (within + 0.5) / n_ev_rep * dur_rep
    phase_start = np.concatenate([[0.0], np.cumsum(dur)])[:-1]
    base = 0.0 if epoch_mode == "layer" else np.repeat(phase_start[a_phase], n_ev)
    t = base + offs

    if epoch_mode == "layer":
        # epoch boundaries at phase access-train boundaries
        acc_per_phase = np.concatenate([[0], np.cumsum(counts)])
        epoch_ptr = excl[acc_per_phase]
        native = tuple(float(d) for d in dur)
    else:
        epoch_ptr = np.asarray([0, N], np.int64)
        native = (float(dur.sum()),)
        names = ("step",)
    return TraceSkeleton(
        t_ns=t,
        bytes_=np.repeat(share, n_ev),
        is_write=np.repeat(np.asarray(acc_write, bool), n_ev),
        region=np.repeat(np.asarray(rid, np.int64), n_ev).astype(np.int32),
        epoch_ptr=epoch_ptr,
        native_ns=native,
        epoch_names=names,
        granularity_bytes=float(granularity_bytes),
    )


def skeleton_to_events(
    skeleton: TraceSkeleton, pool_of_region: np.ndarray
) -> List[MemEvents]:
    """The per-scenario half: gather pools, slice epochs.

    ``pool_of_region`` is a ``[n_regions]`` region→pool vector (e.g.
    :meth:`~repro.core.events.RegionMap.pool_vector` or one row of a
    policy ``assign_batch`` matrix).  O(N) gather + views; no synthesis.
    """
    pool = np.asarray(pool_of_region, np.int32)[skeleton.region]
    out: List[MemEvents] = []
    for e in range(skeleton.n_epochs):
        lo, hi = int(skeleton.epoch_ptr[e]), int(skeleton.epoch_ptr[e + 1])
        out.append(
            # skeletons carry no weight/host columns: synthesis is exact
            # (weight 1) and the host tag is applied downstream by with_host
            MemEvents(  # simlint: ignore[event-columns] -- skeleton build: default weight/host are the correct semantics here
                t_ns=skeleton.t_ns[lo:hi],
                pool=pool[lo:hi],
                bytes_=skeleton.bytes_[lo:hi],
                is_write=skeleton.is_write[lo:hi],
                region=skeleton.region[lo:hi],
            )
        )
    return out


def synthesize_step_trace(
    phases: Sequence[Phase],
    regions: RegionMap,
    hw: HardwareModel = TPU_V5E,
    granularity_bytes: float = 64.0,
    max_events_per_access: int = 64,
    calibration: float = 1.0,
    epoch_mode: str = "step",
) -> Tuple[List[MemEvents], List[float], List[str]]:
    """Expand a phase list into per-epoch event traces.

    Returns ``(traces, native_ns, epoch_names)``; in ``'step'`` mode there is
    one epoch covering all phases, in ``'layer'`` mode one epoch per phase.
    ``calibration`` scales every byte count.

    Composition of :func:`synthesize_skeleton` (placement-independent) and
    :func:`skeleton_to_events` (pool gather of the regions' current
    placement) — same events, same order as the historical loop.
    """
    skel = synthesize_skeleton(
        phases,
        regions,
        hw,
        granularity_bytes=granularity_bytes,
        max_events_per_access=max_events_per_access,
        calibration=calibration,
        epoch_mode=epoch_mode,
    )
    traces = skeleton_to_events(skel, regions.pool_vector())
    return traces, list(skel.native_ns), list(skel.epoch_names)
