"""Carry the reference's state across: plain arrays in, the port's objects
out.

The reference (``repro``) and the port share no objects.  Their
``FlatTopology`` and ``MemEvents`` have the same fields, so a caller hands
the reference's fields over as numpy arrays (and tuples, for names) and gets
the port's object built from exactly those values — both packages then
provably compute on the same topology and traces.  Model parameters cross
the same way: the reference's parameter tree as numpy arrays in, the port's
:class:`~repro_torch.models.model.Model` out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .core.events import MemEvents
from .core.topology import FlatTopology
from .models.config import ModelConfig
from .models.model import Model

__all__ = ["flat_topology_from_arrays", "mem_events_from_arrays", "model_params_from_arrays"]

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


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def model_params_from_arrays(
    cfg: ModelConfig, tree: Mapping[str, Any], device="cuda"
) -> Model:
    """The port's :class:`Model` holding the reference's parameters.

    ``tree`` is the reference's ``Model.init`` tree with numpy leaves:
    ``blocks`` stacked on a leading ``n_groups`` axis (one slice per group
    module here), every other leaf as it is.  Both packages store matrices
    ``[d_in, d_out]`` and apply them as ``x @ W``, so nothing is transposed.
    Every parameter of the port must be given, with its shape, and nothing
    else."""
    model = Model(cfg, device=device)
    flat = _flatten(tree)
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.startswith("blocks."):
                _, g, rest = name.split(".", 2)
                key, index = f"blocks.{rest}", (int(g),)
            else:
                key, index = name, ()
            if key not in flat:
                raise KeyError(f"the tree has no leaf {key!r} for parameter {name!r}")
            value = np.array(np.asarray(flat[key])[index], dtype=np.float32)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: the tree gives shape {value.shape}, the port needs "
                    f"{tuple(param.shape)}"
                )
            param.copy_(torch.from_numpy(value))
            used.add(key)
    unknown = set(flat) - used
    if unknown:
        raise KeyError(f"the port has no parameters for {sorted(unknown)}")
    return model
