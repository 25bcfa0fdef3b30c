"""Sharding: the leading-axis split of a stacked dispatch over a
``('data',)`` mesh, and the model's logical tensor classes -> mesh
partition specs (port of ``repro/distributed/sharding.py``).

**The split.**  The analyzer's coalesced sessions, the sweep's scenarios and
the fleet's rack planes stack on one leading ``K`` axis.  With a mesh, ``K``
is padded to a multiple of the mesh's entries (:func:`pad_to_multiple`),
each entry takes one contiguous slice of it (:func:`shard_rows`) and runs
the same per-row analysis on its own device, and everything structural (the
topology's tensors) is copied once per distinct device
(:func:`replicated`).  :func:`resolve_data_mesh` validates a mesh for a
dispatch and falls back, with the reference's warning, to the first
``rows`` entries when there are fewer rows than entries.

**The rules.**  Mesh axes ``('data', 'model')`` single-pod, ``('pod',
'data', 'model')`` multi-pod.  Strategies, as in the reference:

  * ``'dp_tp'`` — batch on (pod, data); attention heads, FFN hidden and
    vocab on 'model'; parameters otherwise replicated over 'data'.
  * ``'fsdp_tp'`` — additionally shards every weight's input dim over
    'data' (ZeRO-3 style).

plus the suffixes ``'+moe_dp'``, ``'+gqa_fix'`` and ``'+ep_data'``.  Every
rule checks divisibility: a dim that does not divide its mesh axis stays
unsharded.  The rules read the port's parameter names: a per-group
parameter ``blocks.{g}.{rest}`` takes the reference's spec for
``blocks.{rest}`` without its leading entry, which belongs to the stacked
``n_groups`` axis the port does not have
(:func:`repro_torch.interop.reference_leaf`).  :func:`named` turns a spec
into ``torch.distributed.tensor`` placements, one per mesh axis.  Nothing
in the port executes a sharded model, as nothing in the reference does:
its rules feed only the dry run.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh, mesh_devices

__all__ = [
    "PartitionSpec",
    "Replicas",
    "batch_axes",
    "check_mesh",
    "input_pspecs",
    "named",
    "opt_pspecs",
    "pad_to_multiple",
    "param_pspecs",
    "replicated",
    "resolve_data_mesh",
    "shard_rows",
    "timed_device_put",
    "tree_named",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of axis names, or
    ``None`` (unsharded); the port's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# --------------------------------------------------------------------------- #
# The leading-axis ('data') split of a stacked dispatch
# --------------------------------------------------------------------------- #


def resolve_data_mesh(mesh: Optional[Mesh], rows: int, *, what: str = "dispatch"):
    """Validate ``mesh`` for splitting ``rows`` leading-axis rows.

    Returns ``(mesh, n_shards)``.  ``(None, 1)`` means the split does not
    engage: no mesh, nothing to split, a 'data' axis of one entry, or one
    row.  When the 'data' axis has more entries than there are rows, it
    warns and falls back to a submesh over the first ``rows`` entries."""
    if mesh is None or rows <= 0:
        return None, 1
    if "data" not in mesh.axis_names:
        raise ValueError(
            f"sharded {what} needs a mesh with a 'data' axis; got axes "
            f"{tuple(mesh.axis_names)} — build one with "
            "repro_torch.launch.mesh.make_data_mesh()"
        )
    n = int(mesh.shape["data"])
    for ax in mesh.axis_names:
        if ax != "data" and int(mesh.shape[ax]) != 1:
            raise ValueError(
                f"sharded {what} shards only the 'data' axis; mesh axis "
                f"{ax!r} has size {mesh.shape[ax]} > 1 (leading-axis rows "
                "cannot also shard over it)"
            )
    if n <= 1:
        return None, 1
    if n > rows:
        warnings.warn(
            f"mesh has {n} devices on 'data' but the {what} has only "
            f"{rows} rows; falling back to {rows} shard(s)",
            stacklevel=3,
        )
        if rows == 1:
            return None, 1
        return Mesh(mesh_devices(mesh)[:rows], ("data",)), rows
    mesh_devices(mesh)  # an abstract mesh has nothing to dispatch on
    return mesh, n


def check_mesh(mesh: Optional[Mesh], device: torch.device) -> Optional[Mesh]:
    """``mesh`` if its entries share ``device``'s type (the dispatch's own
    device: a mesh splits work over devices of that type); None passes."""
    if mesh is not None:
        types = {d.type for d in mesh_devices(mesh)}
        if types != {device.type}:
            raise ValueError(
                f"mesh entries on {sorted(types)} for a dispatch on {device.type}: "
                "a mesh splits work over devices of the dispatch's own type"
            )
    return mesh


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n`` (k <= 1 => n)."""
    if k <= 1:
        return n
    return ((n + k - 1) // k) * k


def shard_rows(mesh: Optional[Mesh], x):
    """``x``'s leading axis in ``mesh``'s shards: one contiguous slice per
    entry, in mesh order, each a tensor on its entry's device (a numpy
    array is copied straight from its slice).  ``x`` passes through when
    ``mesh`` is None.  The leading dim must be a multiple of the entries
    (callers pad with :func:`pad_to_multiple` first)."""
    if mesh is None:
        return x
    devs = mesh_devices(mesh)
    rows = int(x.shape[0])
    if rows % len(devs):
        raise ValueError(f"{rows} rows do not split over {len(devs)} mesh entries")
    per = rows // len(devs)
    out = []
    for i, dev in enumerate(devs):
        part = x[i * per : (i + 1) * per]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out.append(part.to(dev))
    return out


def replicated(mesh: Optional[Mesh], x: torch.Tensor):
    """``x`` on every entry of ``mesh``, in mesh order: one copy per
    distinct device, shared by the entries that repeat it (and no copy
    where ``x`` already lies).  Callers make it once and keep it, not per
    dispatch.  ``x`` passes through when ``mesh`` is None."""
    if mesh is None:
        return x
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in mesh_devices(mesh):
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return out


class Replicas:
    """A fixed set of tensors (a topology's, say; entries may be None) kept
    on every device a dispatch has split over: :meth:`on` makes the copies
    onto a device the first time it is named (:func:`replicated`) and keeps
    them for every later dispatch."""

    def __init__(self, tensors):
        self._own = tuple(tensors)
        self._on: Dict[torch.device, Tuple[Optional[torch.Tensor], ...]] = {}

    def on(self, devices) -> List[Tuple[Optional[torch.Tensor], ...]]:
        """The tensors on each of ``devices``, in order."""
        new = [d for d in dict.fromkeys(devices) if d not in self._on]
        if new:
            sub = Mesh(new, ("data",))
            cols = [[None] * len(new) if t is None else replicated(sub, t) for t in self._own]
            for i, d in enumerate(new):
                self._on[d] = tuple(c[i] for c in cols)
        return [self._on[d] for d in devices]


def timed_device_put(tree, mesh: Optional[Mesh] = None, spec: Optional[PartitionSpec] = None,
                     device="cuda"):
    """H2D placement with its wall clock, measured on the host once every
    copy has landed.  Returns ``(placed, seconds)``.  ``tree`` is a list,
    tuple or dict of arrays or tensors.  Without ``mesh`` each leaf goes to
    ``device``; with it, to every entry (:func:`replicated`, ``spec`` None
    or all ``None``) or split on its leading axis (:func:`shard_rows`,
    ``spec`` naming 'data' first and nothing else)."""
    if spec is not None and any(a is not None for a in tuple(spec)[1:]):
        raise ValueError(f"only the leading axis splits over a mesh, got {spec}")
    split = spec is not None and len(spec) > 0 and spec[0] == "data"
    if spec is not None and len(spec) > 0 and spec[0] not in (None, "data"):
        raise ValueError(f"the leading axis splits over 'data' only, got {spec}")

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if mesh is None:
            return t.to(device)
        return shard_rows(mesh, t) if split else replicated(mesh, t)

    t0 = time.perf_counter()
    if isinstance(tree, Mapping):
        out: Any = {k: put(v) for k, v in tree.items()}
    else:
        out = type(tree)(put(v) for v in tree)
    devs = {torch.device(device)} if mesh is None else set(mesh_devices(mesh))
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


# --------------------------------------------------------------------------- #
# The model's rules on a production-shaped mesh
# --------------------------------------------------------------------------- #


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _ok(mesh: Mesh, dim: int, axis) -> Optional[Any]:
    """Return axis if dim divides its mesh extent, else None."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 else None


def _rule_path(name: str) -> Tuple[str, ...]:
    """The reference's leaf path of a port parameter name: the group index
    of ``blocks.{g}.{rest}`` dropped."""
    parts = tuple(name.split("."))
    if parts[0] == "blocks" and len(parts) > 2 and parts[1].isdigit():
        return ("blocks",) + parts[2:]
    return parts


def param_pspecs(params, cfg, mesh: Mesh, strategy: str = "dp_tp") -> Dict[str, PartitionSpec]:
    """One :class:`PartitionSpec` per parameter of ``params`` (a module, or a
    mapping of names to tensors or meta tensors), keyed by name.

    Strategies: ``'dp_tp'``, ``'fsdp_tp'``, plus the ``'+moe_dp'`` suffix
    (expert weights replicated over 'model'), ``'+gqa_fix'`` (a projection
    sharded on 'model' only where its head count divides the axis) and
    ``'+ep_data'`` (experts on 'data', their hidden dim on 'model')."""
    moe_dp = "+moe_dp" in strategy
    gqa_fix = "+gqa_fix" in strategy
    ep_data = "+ep_data" in strategy
    strategy = (
        strategy.replace("+moe_dp", "").replace("+gqa_fix", "").replace("+ep_data", "")
    )
    fsdp = "data" if strategy == "fsdp_tp" else None
    model = "model"
    msize = _axis_size(mesh, model)

    def rule(names: Tuple[str, ...], shape: Tuple[int, ...]) -> PartitionSpec:
        last = names[-1]

        def spec(*axes):
            axes = axes + (None,) * (len(shape) - len(axes))
            return P(*(_ok(mesh, shape[i], a) for i, a in enumerate(axes)))

        if last == "embed":
            v, d = shape
            if v % _axis_size(mesh, model) == 0:
                return P(model, _ok(mesh, d, fsdp))
            return P(None, _ok(mesh, d, model))  # fallback: shard d_model
        if last == "lm_head":
            return spec(fsdp, model)
        if "attn" in names:
            if gqa_fix:
                q_ok = cfg.n_heads % msize == 0
                kv_ok = cfg.n_kv_heads % msize == 0
                if last == "wq":
                    return spec(fsdp, model) if q_ok else spec(fsdp, None)
                if last in ("wk", "wv"):
                    return spec(fsdp, model) if kv_ok else spec(fsdp, None)
                if last == "wo":
                    return spec(model, fsdp) if q_ok else spec(None, fsdp)
                return spec()
            if last in ("wq", "wk", "wv"):
                return spec(fsdp, model)
            if last == "wo":
                return spec(model, fsdp)
            return spec()  # q_norm / k_norm
        if "moe" in names:
            E = cfg.n_experts
            ep_ok = E % _axis_size(mesh, model) == 0 and not moe_dp
            if last == "router":
                return spec(fsdp, None)
            if last in ("wi", "wu"):
                if ep_data:
                    return spec("data", None, model)
                if moe_dp:
                    return spec(None, fsdp, None)
                return spec(model, fsdp, None) if ep_ok else spec(None, fsdp, model)
            if last == "wo":
                if ep_data:
                    return spec("data", model, None)
                if moe_dp:
                    return spec(None, None, fsdp)
                return spec(model, None, fsdp) if ep_ok else spec(None, model, fsdp)
            if last in ("shared_wi", "shared_wu"):
                return spec(fsdp, model)
            if last == "shared_wo":
                return spec(model, fsdp)
            return spec()
        if "mlp" in names:
            if last in ("wi", "wu"):
                return spec(fsdp, model)
            if last == "wo":
                return spec(model, fsdp)
            return spec()
        if "mamba" in names:
            if last == "in_proj":
                return spec(fsdp, model)
            if last == "out_proj":
                return spec(model, fsdp)
            if last == "conv_w":
                return spec(None, model)
            if last == "norm":
                return spec(model)  # inner-width gain, sharded with di
            return spec()  # A_log, dt_bias, D
        return spec()  # norms etc.

    named_params = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) \
        else dict(params)
    return {name: rule(_rule_path(name), tuple(t.shape)) for name, t in named_params.items()}


def opt_pspecs(param_specs, strategy: str = "dp_tp"):
    """Optimizer state specs: the moments mirror the parameters' specs, the
    step count is replicated."""
    return {"mu": param_specs, "nu": param_specs, "step": P()}


def _map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_tree(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def input_pspecs(specs, mesh: Mesh):
    """Sharding of one step's inputs (``configs.input_specs``: a train
    batch or a serving state), the tree's structure kept."""
    b_axes = batch_axes(mesh)
    baxis = b_axes if len(b_axes) > 1 else (b_axes[0] if b_axes else None)

    def rule(names: Tuple[str, ...], leaf) -> PartitionSpec:
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        first = names[0] if names else ""
        if first in ("tokens", "labels", "embeds", "token", "embed"):
            return P(_ok(mesh, shape[0], baxis), *([None] * (len(shape) - 1)))
        if first == "caches":
            last = names[-1]
            if last in ("k", "v"):
                # [G, na, B, Hk, Smax, Dh]: batch + sequence sharding
                _, _, B, _, S, _ = shape
                return P(None, None, _ok(mesh, B, baxis), None, _ok(mesh, S, "model"), None)
            if last == "ssm_conv":
                _, _, B, _, di = shape
                return P(None, None, _ok(mesh, B, baxis), None, _ok(mesh, di, "model"))
            if last == "ssm_state":
                _, _, B, H, _, _ = shape
                return P(None, None, _ok(mesh, B, baxis), _ok(mesh, H, "model"), None, None)
        if first == "cache_len":
            return P()
        return P(*([None] * len(shape)))

    return _map_tree(rule, specs)


def named(mesh: Mesh, spec: PartitionSpec) -> List[Any]:
    """``spec`` as ``torch.distributed.tensor`` placements, one per mesh
    axis in the mesh's order: ``Shard(i)`` where tensor dim ``i`` names the
    axis (alone or in a tuple), ``Replicate()`` elsewhere.  Built without a
    process group."""
    from torch.distributed.tensor import Replicate, Shard

    out: List[Any] = []
    for axis in mesh.axis_names:
        dims = [i for i, a in enumerate(spec)
                if a == axis or (isinstance(a, tuple) and axis in a)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {axis!r} names tensor dims {dims} in {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def tree_named(mesh: Mesh, spec_tree):
    """:func:`named` over every spec of a tree of specs."""
    return _map_tree(lambda _, s: named(mesh, s), spec_tree)
