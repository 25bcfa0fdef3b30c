"""Carry the reference's state across: plain arrays in, the port's objects
out.

The reference (``repro``) and the port share no objects.  Their
``FlatTopology`` and ``MemEvents`` have the same fields, so a caller hands
the reference's fields over as numpy arrays (and tuples, for names) and gets
the port's object built from exactly those values — both packages then
provably compute on the same topology and traces.  Model parameters cross
the same way: the reference's parameter tree as numpy arrays in, the port's
:class:`~repro_torch.models.model.Model` out, and back
(:func:`params_to_arrays`); so does the AdamW state
(:func:`adamw_state_to_arrays`, :func:`adamw_state_from_arrays`).

Names: the port's parameter ``blocks.{g}.{rest}`` is slice ``g`` of the
reference's leaf ``blocks.{rest}``, stacked on a leading ``n_groups`` axis
(:func:`reference_leaf`); every other name is the reference's path, dotted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .core.analyzer import _check_device
from .core.events import MemEvents
from .core.topology import FlatTopology
from .models.config import ModelConfig
from .models.model import Model

__all__ = [
    "adamw_state_from_arrays",
    "adamw_state_to_arrays",
    "flat_topology_from_arrays",
    "mem_events_from_arrays",
    "model_params_from_arrays",
    "params_to_arrays",
    "reference_leaf",
    "reference_leaves",
]

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


def reference_leaf(name: str) -> Tuple[str, Optional[int]]:
    """The reference's dotted leaf path of the port's parameter ``name`` and
    the group slice it is: ``('blocks.sub0.attn.wq', 3)`` for
    ``blocks.3.sub0.attn.wq``, ``('embed', None)`` for ``embed``."""
    if name.startswith("blocks."):
        _, g, rest = name.split(".", 2)
        return f"blocks.{rest}", int(g)
    return name, None


def reference_leaves(names) -> List[List[str]]:
    """The port's parameter ``names`` grouped by the reference's leaf, in
    ``jax.tree.leaves`` order (sorted keys at every level), each leaf's
    groups in order: what the reference computes on one stacked array, the
    port computes over one such list."""
    leaves: Dict[Tuple[str, ...], list] = {}
    for name in names:
        key, g = reference_leaf(name)
        leaves.setdefault(tuple(key.split(".")), []).append((-1 if g is None else g, name))
    return [[name for _, name in sorted(parts)] for _, parts in sorted(leaves.items())]


def _named(params) -> Mapping[str, torch.Tensor]:
    """A module's ``named_parameters()``, or the mapping itself."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def _stack_groups(parts: Mapping[Optional[int], np.ndarray], key: str) -> np.ndarray:
    """One reference leaf from its parts: ``{None: array}`` as it is, or
    the group slices ``{0: ..., 1: ..., ...}`` stacked in group order."""
    if None in parts:
        return parts[None]
    groups = sorted(parts)
    if groups != list(range(len(groups))):
        raise ValueError(f"{key}: groups {groups} are not 0..{len(groups) - 1}")
    return np.stack([parts[g] for g in groups])


def _slices(tree: Mapping[str, Any], like: Mapping[str, torch.Tensor]) -> Iterator:
    """``(name, array)`` for every tensor of ``like`` (the port's names):
    the reference tree's leaf, or its group slice, with the tensor's shape.
    Every leaf of the tree must be used."""
    flat = _flatten(tree)
    used = set()
    for name, t in like.items():
        key, g = reference_leaf(name)
        if key not in flat:
            raise KeyError(f"the tree has no leaf {key!r} for parameter {name!r}")
        value = np.asarray(flat[key])
        if g is not None:
            value = value[g]
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(
                f"{name}: the tree gives shape {value.shape}, the port needs {tuple(t.shape)}"
            )
        used.add(key)
        yield name, value
    unknown = set(flat) - used
    if unknown:
        raise KeyError(f"the port has no parameters for {sorted(unknown)}")


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
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in _slices(tree, params):
            params[name].copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 (which numpy lacks) widens to f32, exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_arrays(params) -> Dict[str, Any]:
    """The reference's tree of numpy arrays holding ``params``: a
    :class:`Model`, or a mapping of the port's parameter names to tensors
    (gradients, AdamW moments).  ``blocks`` leaves are restacked on a
    leading ``n_groups`` axis; the inverse of :func:`model_params_from_arrays`."""
    stacked: Dict[str, Dict[Optional[int], np.ndarray]] = {}
    for name, t in _named(params).items():
        key, g = reference_leaf(name)
        stacked.setdefault(key, {})[g] = _to_numpy(t)
    tree: Dict[str, Any] = {}
    for key, parts in stacked.items():
        *path, leaf = key.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = _stack_groups(parts, key)
    return tree


def adamw_state_to_arrays(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's ``adamw_init`` / ``adamw_update`` state (``mu``,
    ``nu`` as parameter trees, ``step`` an int32 scalar) from the port's."""
    return {
        "mu": params_to_arrays(state["mu"]),
        "nu": params_to_arrays(state["nu"]),
        "step": np.asarray(_to_numpy(state["step"]), dtype=np.int32),
    }


def adamw_state_from_arrays(
    tree: Mapping[str, Any], params, device="cuda", moment_dtype=torch.float32
) -> Dict[str, Any]:
    """The port's AdamW state from the reference's: ``mu`` and ``nu`` keyed
    by the names of ``params`` (a :class:`Model` or a mapping of names to
    tensors), in ``moment_dtype`` on ``device``; ``step`` an int32 scalar."""
    dev = _check_device(device)
    named = _named(params)

    def moments(part):
        return {name: torch.from_numpy(np.array(value)).to(dev, moment_dtype)
                for name, value in _slices(part, named)}

    return {
        "mu": moments(tree["mu"]),
        "nu": moments(tree["nu"]),
        "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=dev),
    }
