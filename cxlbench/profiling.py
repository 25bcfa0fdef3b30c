"""Reduction of a ``torch.profiler`` trace of the measured window: the
device's busy seconds (the union of kernel, copy and set intervals; the
device-side copies of host annotations are not work), each device
operation's seconds, and the longest idle gaps, each named by what the host
was doing then (the innermost ``cxlbench.*`` span and the innermost host
operation at the gap's middle).  It reads the profiler's raw events, which
costs a fraction of building its event tree."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

SPAN_PREFIX = "cxlbench."


def _interval_ns(k) -> tuple:
    start = k.start_ns()
    return start, (k.end_ns() if hasattr(k, "end_ns") else start + k.duration_ns())


def _is_annotation(k) -> bool:
    flag = getattr(k, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else k.name().startswith(SPAN_PREFIX)


class Trace:
    def __init__(self, prof):
        dev, host, dev_names, host_names = [], [], [], []
        cpu = torch.autograd.DeviceType.CPU
        for k in prof.profiler.kineto_results.events():
            a, b = _interval_ns(k)
            if b <= a:
                continue
            if k.device_type() == cpu:
                host.append((a, b))
                host_names.append(k.name())
            elif not _is_annotation(k):
                dev.append((a, b))
                dev_names.append(k.name())
        order = sorted(range(len(dev)), key=dev.__getitem__)
        self.device = [(dev[i][0], dev[i][1], dev_names[i]) for i in order]
        self.host = np.asarray(host, np.int64).reshape(-1, 2)
        self.host_names = host_names
        merged: List[List[int]] = []
        for a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy = merged
        self.busy_s = sum(b - a for a, b in merged) * 1e-9

    def op_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for a, b, name in self.device:
            out[name] = out.get(name, 0.0) + (b - a) * 1e-9
        return out

    def kernel_seconds(self, needle: str) -> float:
        """Seconds of the device operations whose name contains ``needle``."""
        return sum(s for name, s in self.op_seconds().items() if needle in name)

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches between the first and the last
        recorded instant in which nothing ran on the device."""
        starts = ([int(self.host[:, 0].min())] if len(self.host) else []) + \
            [a for a, _, _ in self.device[:1]]
        ends = ([int(self.host[:, 1].max())] if len(self.host) else []) + \
            [b for _, b in self.busy[-1:]]
        if not starts:
            return []
        gaps, cur, end = [], min(starts), max(ends)
        for a, b in self.busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if end > cur:
            gaps.append((cur, end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self._label((a + b) // 2), (b - a) * 1e-9] for a, b in gaps]

    def _label(self, t: int) -> str:
        inside = np.nonzero((self.host[:, 0] <= t) & (t <= self.host[:, 1]))[0]
        span = op = None
        for i in inside[np.argsort(self.host[inside, 1] - self.host[inside, 0])]:
            name = self.host_names[i]
            if name.startswith(SPAN_PREFIX):
                span = span or name
            else:
                op = op or name
        parts = [x for x in (span, op) if x is not None]
        return " / ".join(parts) if parts else "host: no recorded op"
