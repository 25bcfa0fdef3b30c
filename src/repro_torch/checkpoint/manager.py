"""Fault-tolerance manager: periodic checkpoints, restart, straggler watch
(port of ``repro/checkpoint/manager.py``; host code, line for line).

  * **periodic atomic checkpoints** with retention (keep the last N): a
    failure loses at most ``interval`` steps;
  * **restart**: ``resume_or_init`` restores the newest committed step into
    a fresh state, or returns the fresh state;
  * **straggler watch**: per-step durations feed an EWMA; steps slower
    than ``straggler_factor`` x the EWMA are flagged (and kept out of it);
  * **preemption-signal checkpoint**: ``request_checkpoint()`` forces a
    save at the next step boundary (what a SIGTERM handler calls).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional

from . import ckpt

__all__ = ["CheckpointManager", "FaultToleranceConfig"]


@dataclasses.dataclass
class FaultToleranceConfig:
    directory: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    interval_steps: int = 100
    keep: int = 3
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1


class CheckpointManager:
    def __init__(self, cfg: FaultToleranceConfig):
        self.cfg = cfg
        self._ewma: Optional[float] = None
        self._forced = False
        self.straggler_events: List[Dict[str, Any]] = []

    # ---- restart ------------------------------------------------------- #

    def resume_or_init(self, init_fn: Callable[[], Any]):
        """Returns (state, start_step); state = whatever tree init_fn makes,
        restored in place from the newest committed checkpoint if any."""
        step = ckpt.latest_step(self.cfg.directory)
        if step is None:
            return init_fn(), 0
        state, step = ckpt.restore_checkpoint(self.cfg.directory, init_fn(), step=step)
        return state, step + 1

    # ---- periodic save --------------------------------------------------- #

    def request_checkpoint(self):
        self._forced = True

    def maybe_save(self, step: int, state) -> Optional[str]:
        due = step > 0 and step % self.cfg.interval_steps == 0
        if not (due or self._forced):
            return None
        self._forced = False
        path = ckpt.save_checkpoint(self.cfg.directory, step, state)
        self._gc()
        return path

    def _gc(self):
        steps = ckpt.list_steps(self.cfg.directory)
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(
                os.path.join(self.cfg.directory, f"step_{s:08d}"), ignore_errors=True
            )

    # ---- straggler watch --------------------------------------------------- #

    def observe_step(self, step: int, duration_s: float, detail: Optional[Dict] = None) -> bool:
        """Feed a step duration; returns True if flagged as straggler."""
        if self._ewma is None:
            self._ewma = duration_s
            return False
        flagged = duration_s > self.cfg.straggler_factor * self._ewma
        if flagged:
            self.straggler_events.append(
                {"step": step, "duration_s": duration_s, "ewma_s": self._ewma, **(detail or {})}
            )
        # the EWMA excludes flagged steps so one straggler doesn't poison the baseline
        if not flagged:
            a = self.cfg.ewma_alpha
            self._ewma = (1 - a) * self._ewma + a * duration_s
        return flagged
