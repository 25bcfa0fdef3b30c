"""Device meshes for the split of a stacked dispatch's leading axis (port of
``repro/launch/mesh.py``).

A :class:`Mesh` is a named grid of ``torch.device`` entries, the port's
counterpart of ``jax.sharding.Mesh``: ``axis_names``, ``shape`` (axis name
-> size, as in JAX) and ``devices`` (an object array of that shape).  Its
size counts entries, not distinct devices: a *virtual* mesh repeats one
device ``n`` times, the port's counterpart of XLA's
``--xla_force_host_platform_device_count``, so ``virtual=True`` over
``"cpu"`` gives the tests a mesh of 8 and over ``"cuda:0"`` gives a one-card
machine the same split that 8 cards would run.  An *abstract* mesh
(:func:`make_abstract_mesh`) has a shape and no devices; the sharding rules
(``repro_torch.distributed.sharding``) read only its shape.

``make_production_mesh`` (XLA's 512 virtual devices for the dry run) stays
in the JAX package with ``dryrun.py`` and ``hillclimb.py``, its only users.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Mesh",
    "make_abstract_mesh",
    "make_data_mesh",
    "make_local_mesh",
    "mesh_devices",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit index on the card
    (``"cuda"`` is the current device).  Raises when no card is present or
    the index names a card that does not exist."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but no CUDA device is available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(
            f"device cuda:{index} does not exist: {torch.cuda.device_count()} "
            "CUDA device(s) present"
        )
    return torch.device("cuda", index)


class Mesh:
    """A named grid of devices.  ``devices`` is anything ``np.asarray``
    turns into an array of ``len(axis_names)`` dimensions whose entries name
    devices (``torch.device`` or strings); each entry is resolved
    (:func:`resolve_device`), so a mesh never names a card that is absent.
    ``devices=None`` with ``shape`` makes an abstract mesh."""

    def __init__(
        self,
        devices,
        axis_names: Sequence[str],
        shape: Optional[Sequence[int]] = None,
    ):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        if devices is None:
            if shape is None:
                raise ValueError("an abstract mesh needs its shape")
            dims = tuple(int(s) for s in shape)
            self.devices = None
        else:
            entries = np.empty(np.shape(np.asarray(devices, dtype=object)), dtype=object)
            for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
                entries[idx] = resolve_device(d)
            dims = entries.shape
            if shape is not None and tuple(int(s) for s in shape) != dims:
                raise ValueError(f"shape {tuple(shape)} != the devices' {dims}")
            self.devices = entries
        if len(dims) != len(self.axis_names):
            raise ValueError(f"shape {dims} / axes {self.axis_names} length mismatch")
        if any(s < 1 for s in dims):
            raise ValueError(f"mesh shape {dims} has an empty axis")
        self._dims = dims

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._dims))

    @property
    def size(self) -> int:
        """The mesh's entries (a virtual mesh counts each repeat)."""
        return int(np.prod(self._dims))

    def __repr__(self) -> str:
        if self.devices is None:
            return f"Mesh(abstract, {self.shape})"
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def mesh_devices(mesh: Mesh) -> List[torch.device]:
    """The mesh's entries in row-major order (the order its shards take)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch.launch.mesh.Mesh, got {type(mesh).__name__}")
    if mesh.devices is None:
        raise ValueError("an abstract mesh has no devices to dispatch on")
    return list(mesh.devices.reshape(-1))


def make_abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over ``axes`` with no devices: the production
    layouts (16 x 16, 2 x 16 x 16) for the sharding rules and their tests."""
    shape_t = tuple(int(s) for s in shape)
    axes_t = tuple(axes)
    if len(shape_t) != len(axes_t):
        raise ValueError(f"shape {shape_t} / axes {axes_t} length mismatch")
    return Mesh(None, axes_t, shape=shape_t)


def _available(device) -> List[torch.device]:
    """Every device of ``device``'s type: the cards, or the one CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over 'cuda' asked for, but no CUDA device is available; "
            "pass device='cpu' (with virtual=True for more than one entry)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_local_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A small ``('data', 'model')`` mesh over the devices that exist, each
    axis clamped to them as in the reference (tests, examples)."""
    devs = _available(device)
    n = len(devs)
    data = max(1, min(int(data), n))
    model = max(min(int(model), n // data), 1)
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devs[: data * model]):
        grid[i // model, i % model] = d
    return Mesh(grid, ("data", "model"))


def make_data_mesh(n: Optional[int] = None, device="cuda", virtual: bool = False) -> Mesh:
    """1-D ``('data',)`` mesh: the shape the analyzer's, the engine's, the
    sweep's and the fleet's ``mesh=`` split their leading axis over.

    By default over the first ``n`` (default: all) devices of ``device``'s
    type, ``n`` clamped to those present; it raises when ``device`` is
    ``"cuda"`` and no card is present.  ``virtual=True`` repeats the one
    device ``device`` (``"cuda:0"``, ``"cpu"``) ``n`` times instead."""
    if virtual:
        if n is None or int(n) < 1:
            raise ValueError(f"a virtual mesh needs n >= 1 entries, got {n}")
        dev = resolve_device(device)
        grid = np.empty((int(n),), dtype=object)
        for i in range(int(n)):
            grid[i] = dev
        return Mesh(grid, ("data",))
    devs = _available(device)
    n = len(devs) if n is None else max(1, min(int(n), len(devs)))
    grid = np.empty((n,), dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid, ("data",))
