"""Program spans: named intervals of the port's own work, on the profiler's
clock — the port's one span mechanism.

``with span("engine.launch"):`` marks the work inside.  With no profiler
running in the process (``torch.profiler`` or ``torch.autograd.profiler``),
:func:`span` returns one shared null context: no ``record_function``, no
clock read, no allocation.  With one running, it opens
``record_function("repro_torch." + name)``, so the span shows in the trace
of every thread the profiler traces, and appends a :class:`Span` to a
bounded record of the whole process, read by :func:`recorded`.

The record exists because a profiler traces only the thread that started it
unless asked for every thread, and the port does its analysis on the
engine's own thread (:mod:`repro_torch.core.engine`): the record is the
program's account of every thread's spans.  Its times are
``time.time_ns()``, the Unix-epoch nanoseconds on which the profiler
stamps its host and device events, so a recorded span can be set against
the device intervals of the same trace.  Each recorded interval encloses
its ``record_function``'s.

Spans (after the ``repro_torch.`` prefix), and the thread that opens each:

  * ``engine.launch``, ``engine.finish``: the engine's thread, around one
    dispatch's launch and its finish (:class:`~.engine.AnalysisEngine`);
    ``engine.submit_wait``, ``engine.flush_wait``: a session's thread,
    while it waits on the engine (backpressure at submit, and flush);
  * ``analyzer.stage`` (validating the epochs, the stager, scale and window
    rows), ``analyzer.transfer`` (the host-to-device copies),
    ``analyzer.launch`` (enqueueing the analysis), ``analyzer.finish``
    (the one device-to-host copy of the totals, which waits on the
    device): whichever thread dispatches (:class:`~.analyzer.EpochAnalyzer`);
  * ``fabric.merge``, ``fabric.native``: the round's merged timelines and
    the tenants' steps (:meth:`~.fabric.FabricSession.round`);
  * ``attach.batch``, ``attach.native``: the step's epoch batch and the
    step itself with its sync (:meth:`~.attach.AttachedProgram.step`);
  * ``sweep.prepare`` (placement, skeletons, topology stack, cascade keys,
    cache scales), ``sweep.stage``, ``sweep.transfer``, ``sweep.launch``
    (the cascades and the reduce), ``sweep.d2h``: the caller's thread
    (:meth:`~.scenario.ScenarioSuite.run`).
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from time import time_ns
from typing import Deque, List, NamedTuple

import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

__all__ = ["CAPACITY", "PREFIX", "Span", "recorded", "span"]

PREFIX = "repro_torch."
CAPACITY = 1 << 16  # spans kept; the oldest go first


class Span(NamedTuple):
    name: str  # without the prefix
    thread: str
    start_ns: int
    end_ns: int


_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_record: Deque[Span] = deque(maxlen=CAPACITY)


class _Open:
    """One span while a profiler runs."""

    __slots__ = ("name", "_rf", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Open":
        self._start = time_ns()
        self._rf = record_function(PREFIX + self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        end = time_ns()
        with _lock:
            _record.append(Span(self.name, threading.current_thread().name, self._start, end))
        return False


def span(name: str):
    """A context that marks ``name``'s work while a profiler runs, and
    does nothing otherwise (the module docstring)."""
    # a process-wide flag the profiler sets on start, read on every thread
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name)


def recorded() -> List[Span]:
    """The spans recorded so far in this process, in the order they ended
    (at most :data:`CAPACITY`)."""
    with _lock:
        return list(_record)
