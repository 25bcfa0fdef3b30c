"""Carry the reference's state across: plain arrays in, the port's objects
out.

The reference (``repro``) and the port share no objects.  Their
``FlatTopology`` and ``MemEvents`` have the same fields, so a caller hands
the reference's fields over as numpy arrays (and tuples, for names) and gets
the port's object built from exactly those values — both packages then
provably compute on the same topology and traces.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from .core.events import MemEvents
from .core.topology import FlatTopology

__all__ = ["flat_topology_from_arrays", "mem_events_from_arrays"]

def _check_keys(d: Mapping[str, Any], cls) -> None:
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    required = {
        f.name
        for f in dataclasses.fields(cls)
        if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
    }
    missing = required - set(d)
    if missing:
        raise KeyError(f"{cls.__name__} needs fields {sorted(missing)}")


def flat_topology_from_arrays(d: Mapping[str, Any]) -> FlatTopology:
    """The port's :class:`FlatTopology` from the reference's fields: arrays
    are copied (dtypes kept), name tuples and scalars converted."""
    _check_keys(d, FlatTopology)
    out = {}
    for name, v in d.items():
        if v is None or isinstance(v, (str, bool, int, float)):
            out[name] = v
        elif isinstance(v, (tuple, list)):
            out[name] = tuple(v)
        else:
            out[name] = np.array(v, copy=True)
    for name in ("n_pools", "n_switches", "n_hosts", "n_qos_classes"):
        if name in out:
            out[name] = int(out[name])
    out["local_latency_ns"] = float(out["local_latency_ns"])
    return FlatTopology(**out)


def mem_events_from_arrays(d: Mapping[str, Any]) -> MemEvents:
    """The port's :class:`MemEvents` from the reference's columns (copied,
    dtypes kept)."""
    _check_keys(d, MemEvents)
    return MemEvents(
        **{name: np.array(v, copy=True) for name, v in d.items() if v is not None}
    )
