"""The host a run stands on: the card's clocks and the cores local to it,
the pinning of the run's threads to fixed cores, and what the host did
over the measured window (each thread's core and CPU seconds, the
machine's stolen and idle time, a fixed probe of the core's speed).  The
run prints these on an earlier line of standard error, so that two runs
that read apart can be told apart by their host.  Nothing here imports
numpy at import time: the pinning comes before any library starts its
threads."""

from __future__ import annotations

import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_QUERY = "name,power.limit,pci.bus_id,clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu,power.draw"


def card() -> Dict[str, str]:
    """The first card's fields of ``_QUERY`` as nvidia-smi reads them (empty
    where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={_QUERY}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        line = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(_QUERY.split(","), (v.strip() for v in line.split(","))))


def _cpulist(text: str) -> List[int]:
    cores = []
    for part in text.strip().split(","):
        if "-" in part:
            a, b = part.split("-")
            cores += range(int(a), int(b) + 1)
        elif part:
            cores.append(int(part))
    return cores


def local_cores(bus_id: str) -> List[int]:
    """The cores this process may use that are local to the card at PCI
    ``bus_id`` (all it may use where the machine does not say)."""
    allowed = sorted(os.sched_getaffinity(0))
    if bus_id.count(":") != 2:  # empty, or "[N/A]" where the machine hides it
        return allowed
    dom, rest = bus_id.lower().split(":", 1)
    path = Path("/sys/bus/pci/devices") / f"{dom[-4:]}:{rest}" / "local_cpulist"
    try:
        local = set(_cpulist(path.read_text()))
    except (OSError, ValueError):
        return allowed
    return sorted(local & set(allowed)) or allowed


class Pinning:
    """Fixed cores for a run: the main thread on the first, the other
    Python threads (the analysis engine's) on the second, and every other
    thread (the CUDA driver's, the intra-op pool's) on the rest; with fewer
    than three cores, all on all.  ``start`` pins the calling main thread
    to the rest, so that what it starts inherits them; ``settle`` then
    moves the Python threads to their own cores and records the cores each
    thread is left with, as the machine reads them back.  A machine that
    refuses a pinning leaves that thread where it was, and the record says
    so."""

    def __init__(self, cores: List[int]):
        self.cores = cores
        self.own = len(cores) >= 3
        self.rest = cores[2:] if self.own else cores
        self.refused: List[str] = []

    def _set(self, tid: int, cores: List[int], who: str) -> None:
        try:
            os.sched_setaffinity(tid, cores)
        except OSError as e:
            self.refused.append(f"{who}: {e}")

    def start(self) -> None:
        self._set(0, self.rest, "start")

    def settle(self) -> Dict[str, object]:
        main = threading.main_thread()
        threads = [main] + [t for t in threading.enumerate() if t is not main and t.native_id]
        if self.own:
            self._set(main.native_id, [self.cores[0]], main.name)
            for t in threads[1:]:
                self._set(t.native_id, [self.cores[1]], t.name)
        placed: Dict[str, object] = {}
        for t in threads:
            try:
                placed[t.name] = sorted(os.sched_getaffinity(t.native_id))
            except OSError:  # the thread ended meanwhile
                continue
        if self.refused:
            placed["refused"] = self.refused
        return placed


def probe_ms(reps: int = 5) -> float:
    """The fastest of ``reps`` sorts of the same 2**20 doubles, in ms: the
    core's speed at that moment."""
    import numpy as np

    x = np.random.default_rng(0).standard_normal(1 << 20)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.sort(x)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def _cpu_ticks() -> Optional[List[int]]:
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:9]]  # user .. steal
    except OSError:
        return None


def _threads() -> Dict[int, tuple]:
    """Each thread of this process: ``(name, last core, CPU ticks)``."""
    out = {}
    for task in Path("/proc/self/task").iterdir():
        try:
            stat = (task / "stat").read_text()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        f = stat[stat.rindex(")") + 2:].split()
        out[int(task.name)] = (name, int(f[36]), int(f[11]) + int(f[12]))
    return out


class Window:
    """What the host did between ``open`` and ``close``: the machine's
    stolen and idle shares of its CPU time, and each busy thread's core and
    CPU seconds."""

    def open(self) -> None:
        self.ticks, self.tasks = _cpu_ticks(), _threads()

    def close(self) -> Dict[str, object]:
        ticks, tasks = _cpu_ticks(), _threads()
        hz = os.sysconf("SC_CLK_TCK")
        out: Dict[str, object] = {}
        if ticks is not None and self.ticks is not None:
            d = [a - b for a, b in zip(ticks, self.ticks)]
            total = max(sum(d), 1)
            out["steal_share"] = float(d[7] / total)
            out["idle_share"] = float((d[3] + d[4]) / total)
        names = {t.native_id: t.name for t in threading.enumerate()}
        busy = []
        for tid, (name, core, cpu) in tasks.items():
            used = (cpu - self.tasks.get(tid, (name, core, 0))[2]) / hz
            if used >= 0.05:
                busy.append((names.get(tid, name), core, round(used, 2)))
        out["threads"] = sorted(busy, key=lambda b: -b[2])
        return out
