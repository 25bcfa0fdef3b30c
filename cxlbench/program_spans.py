"""The program's own spans (``repro_torch.core.spans``) that a traced run
recorded: those of every thread, the engine's among them, which the
profiler's trace holds only for the thread that started it.  The readers
take the spans that lie inside the trace's host time range, which the
spans share the clock of; a program without the span record, or a run
without a trace, gives nothing."""

from __future__ import annotations

from typing import List, Optional


def in_trace(ctx, names) -> Optional[List]:
    """The recorded spans named in ``names`` that lie inside the trace's
    host time range, or None without a trace or a span record."""
    tr = ctx["trace"]
    if tr is None or not len(tr.host):
        return None
    try:
        from repro_torch.core import spans
    except ImportError:  # a program that records no spans
        return None
    lo, hi = int(tr.host[:, 0].min()), int(tr.host[:, 1].max())
    return [s for s in spans.recorded()
            if s.name in names and lo <= s.start_ns and s.end_ns <= hi]


def ms_per_unit(ctx, name: str) -> Optional[float]:
    """Milliseconds of the spans called ``name`` a unit of the window."""
    got = in_trace(ctx, {name})
    units = ctx["counters"]["units"]
    if not got or not units:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in got) / units
