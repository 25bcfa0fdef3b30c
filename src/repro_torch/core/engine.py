"""Session plumbing shared by attached programs (port of the synchronous
part of ``repro/core/engine.py``).

The reference's :class:`AnalysisEngine` — one dispatcher thread, depth-2
backpressure, cross-session coalescing — comes with slice 4 of the port.
Until then every session analyzes synchronously on the caller's thread and
has no engine handle; :class:`EngineClient` keeps the session lifecycle
(``flush`` / ``close`` / context manager) so callers need not change when
the engine arrives.
"""

from __future__ import annotations

__all__ = ["EngineClient", "fold_dispatch_stats"]


def fold_dispatch_stats(report, stats, group_size: int) -> None:
    """Fold one dispatch's observability record into a report.

    ``report`` is any object with ``devices_used`` / ``shard_rows`` /
    ``padded_waste`` / ``coalesced_group_size`` and the timing-split fields
    (:class:`~repro_torch.core.attach.SimReport`).  Device counts, shard
    widths and group sizes keep their maxima; padded waste keeps the worst
    fraction seen; the timing split accumulates.
    """
    if stats is not None:
        report.devices_used = max(report.devices_used, stats.devices_used)
        report.shard_rows = max(report.shard_rows, stats.shard_rows)
        report.padded_waste = max(report.padded_waste, stats.padded_fraction)
        report.stage_s += stats.stage_s
        report.transfer_s += stats.transfer_s
        report.compile_s += stats.compile_s
        report.compute_s += stats.compute_s
        if stats.donated:
            report.donated_dispatches += 1
        if stats.aot_cache_hit:
            report.aot_cache_hits += 1
    if group_size:
        report.coalesced_group_size = max(
            report.coalesced_group_size, int(group_size)
        )


class EngineClient:
    """Lifecycle of a session that folds analysis results into a report.

    Synchronous sessions have nothing in flight, so :meth:`flush` and
    :meth:`close` return at once; they exist so that code written against
    the reference's asynchronous sessions runs unchanged."""

    def flush(self) -> None:
        """Block until every submitted batch has been analyzed and folded
        (synchronous sessions: nothing is ever pending)."""

    def close(self) -> None:
        """Flush and release the session (idempotent)."""
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
