"""Epoch segmentation — the paper's Timer (§3, component 2).  A copy of
``repro/core/timer.py``.

The paper interrupts the traced program periodically; each interval is an
epoch and the Timing Analyzer runs at the boundary.  In the attach setting the
natural epoch boundaries are dispatch points:

  * ``'step'``   — one train/serve step per epoch (default),
  * ``'layer'``  — one transformer layer per epoch (finer attribution; the
                   tracer emits per-layer event slices),
  * ``'quantum'``— fixed simulated-time quantum: a step's trace is re-cut
                   into fixed-duration slices, mimicking the paper's
                   wall-clock epoch timer.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .events import MemEvents
from .units import NS_PER_MS

__all__ = ["EpochSchedule", "slice_by_quantum"]


@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """How execution is divided into epochs."""

    mode: str = "step"  # 'step' | 'layer' | 'quantum'
    quantum_ns: float = float(NS_PER_MS)  # 1 ms; used when mode == 'quantum'

    def __post_init__(self):
        if self.mode not in ("step", "layer", "quantum"):
            raise ValueError(f"unknown epoch mode {self.mode!r}")
        if self.quantum_ns <= 0:
            raise ValueError("quantum_ns must be positive")

    def slices(self, trace: MemEvents, dense: bool = False) -> List[MemEvents]:
        """Cut one step's trace into epoch slices (times re-based per slice)."""
        if self.mode in ("step", "layer"):
            # 'layer' slicing is done upstream by the tracer (it knows layer
            # boundaries); at this point each trace is already one epoch.
            return [trace]
        return slice_by_quantum(trace, self.quantum_ns, dense=dense)


def slice_by_quantum(
    trace: MemEvents, quantum_ns: float, dense: bool = False
) -> List[MemEvents]:
    """Cut a trace on fixed simulated-time quanta.

    By default idle quanta are dropped (the single-host attach behavior:
    only occupied epochs are analyzed).  With ``dense=True`` the returned
    list covers every quantum from 0 through the last occupied one, empty
    slices included, so index ``k`` always means *absolute* quantum ``k`` —
    required when several hosts' slice streams are aligned positionally
    (the fabric session's co-scheduling contract).
    """
    if trace.n == 0:
        return []
    ev = trace.sorted_by_time()
    out: List[MemEvents] = []
    k = np.floor(ev.t_ns / quantum_ns).astype(np.int64)
    if dense:
        # k is non-decreasing (ev is time-sorted): all slice boundaries in
        # one O(N + Q) searchsorted instead of one array scan per quantum
        qmax = int(k[-1])
        bounds = np.searchsorted(k, np.arange(qmax + 2))
        groups = [
            (q, np.arange(bounds[q], bounds[q + 1])) for q in range(qmax + 1)
        ]
    else:
        groups = [(int(q), np.nonzero(k == q)[0]) for q in np.unique(k)]
    for q, idx in groups:
        sl = ev.take(idx)
        # re-base times to the slice's epoch start; every other field —
        # including PEBS-style sampling weights and host tags — rides along
        out.append(dataclasses.replace(sl, t_ns=sl.t_ns - q * quantum_ns))
    return out
