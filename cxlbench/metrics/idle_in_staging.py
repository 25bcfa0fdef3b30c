"""Percent of the window in which the card ran nothing while the analyzer
staged or copied a batch in: the union of the ``analyzer.stage`` and
``analyzer.transfer`` spans less its overlap with the profiler's device
intervals (both on the trace's clock), over the window."""

import numpy as np

from cxlbench import program_spans


def _union(intervals) -> np.ndarray:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return np.asarray(merged, np.int64).reshape(-1, 2)


def read(ctx):
    got = program_spans.in_trace(ctx, {"analyzer.stage", "analyzer.transfer"})
    if not got:
        return None
    staging = _union((s.start_ns, s.end_ns) for s in got)
    busy = np.asarray(ctx["trace"].busy, np.int64).reshape(-1, 2)  # merged, in order
    idle_ns = 0
    for a, b in staging:
        # the busy intervals that meet [a, b]
        i, j = np.searchsorted(busy[:, 1], a, "right"), np.searchsorted(busy[:, 0], b, "left")
        covered = np.minimum(busy[i:j, 1], b) - np.maximum(busy[i:j, 0], a)
        idle_ns += int(b - a) - int(np.clip(covered, 0, None).sum())
    return 100.0 * idle_ns * 1e-9 / ctx["window_s"]
