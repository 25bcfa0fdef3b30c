"""Sharded, atomic checkpoints in the reference's on-disk layout (port of
``repro/checkpoint/ckpt.py``)::

    <dir>/step_00000123/
        manifest.msgpack   # {'step', 'leaves': {name: {shape, dtype, file}}}
        shard_<host>.npz   # this host's leaf data
        _COMMITTED         # written last: the crash-consistent marker

A save writes into ``step_XXXXXXXX.tmp``, then renames it; restore picks
the newest committed step.  Leaves are named by the reference's
``"/"``-joined tree paths in ``jax.tree.leaves`` order (sorted keys): a
:class:`~repro_torch.models.model.Model` (or a mapping of the port's
parameter names, such as the AdamW moments) stands for the reference's
parameter tree, its ``blocks.{g}.*`` parameters stacked on a leading
``n_groups`` axis (:func:`repro_torch.interop.reference_leaf`).  Either
package restores the other's checkpoints.  bf16 tensors are saved as f32
(numpy has no bf16; the widening is exact) and restored into the target's
dtype.

The manifest is msgpack.  The port writes and reads the subset it uses
(maps, strings, integers, arrays of integers) itself, byte for byte as
``msgpack.packb`` writes it, so it needs no msgpack package.
"""

from __future__ import annotations

import os
import re
import shutil
import struct
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..interop import _stack_groups, _to_numpy, reference_leaf

__all__ = ["latest_step", "list_steps", "restore_checkpoint", "save_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d+)$")


# --------------------------------------------------------------------------- #
# the manifest's msgpack subset
# --------------------------------------------------------------------------- #


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 1 << 16:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(obj, int) and not isinstance(obj, bool):
        if 0 <= obj < 128:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < top:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(obj)
        else:
            for code, fmt, bottom in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                      (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if obj >= bottom:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(obj)
    else:
        raise TypeError(f"the manifest's msgpack subset has no {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for maps, strings, integers and arrays."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(b: bytes, i: int) -> Tuple[Any, int]:
    c = b[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
        if c <= 0x8F:
            n = c & 0x0F
        else:
            fmt = ">H" if c == 0xDE else ">I"
            (n,) = struct.unpack_from(fmt, b, i)
            i += struct.calcsize(fmt)
        d = {}
        for _ in range(n):
            k, i = _unpack(b, i)
            d[k], i = _unpack(b, i)
        return d, i
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
        if c <= 0x9F:
            n = c & 0x0F
        else:
            fmt = ">H" if c == 0xDC else ">I"
            (n,) = struct.unpack_from(fmt, b, i)
            i += struct.calcsize(fmt)
        arr = []
        for _ in range(n):
            v, i = _unpack(b, i)
            arr.append(v)
        return arr, i
    if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
        if c <= 0xBF:
            n = c & 0x1F
        else:
            fmt = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c]
            (n,) = struct.unpack_from(fmt, b, i)
            i += struct.calcsize(fmt)
        return b[i:i + n].decode("utf-8"), i + n
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if c in ints:
        (v,) = struct.unpack_from(ints[c], b, i)
        return v, i + struct.calcsize(ints[c])
    raise ValueError(f"msgpack type byte 0x{c:02x} is outside the manifest's subset")


def unpackb(b: bytes):
    """``msgpack.unpackb(b)`` for maps, strings, integers and arrays."""
    obj, i = _unpack(b, 0)
    if i != len(b):
        raise ValueError(f"{len(b) - i} trailing bytes after the msgpack object")
    return obj


# --------------------------------------------------------------------------- #
# trees
# --------------------------------------------------------------------------- #


def _leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Optional[int], Any]]:
    """``(reference path, group index or None, leaf)`` for every tensor or
    array of a port tree: nested mappings (string keys) and sequences; a
    module stands for its ``named_parameters()``; a tensor under a dotted
    key is a parameter (``blocks.{g}.*`` is group slice ``g``)."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            key, g = reference_leaf(k) if isinstance(v, torch.Tensor) else (k, None)
            path = prefix + tuple(key.split("."))
            if g is None:
                yield from _leaves(v, path)
            else:
                yield path, g, v
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield prefix, None, tree
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(map(str, prefix))} is a "
                        f"{type(tree).__name__}, not a tensor or an array")


def _named_leaves(tree) -> Dict[str, Dict[Optional[int], Any]]:
    """Leaves by reference name, in ``jax.tree.leaves`` order, each as
    ``{None: leaf}`` or ``{group: slice}``."""
    named: Dict[Tuple, Dict[Optional[int], Any]] = {}
    for path, g, leaf in _leaves(tree):
        named.setdefault(path, {})[g] = leaf
    return {"/".join(map(str, p)): named[p] for p in sorted(named)}


# --------------------------------------------------------------------------- #
# save / restore
# --------------------------------------------------------------------------- #


def save_checkpoint(directory: str, step: int, tree, host_id: int = 0) -> str:
    """Atomic save; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest = {"step": step, "leaves": {}}
    for name, parts in _named_leaves(tree).items():
        arr = _stack_groups({g: _to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
                             for g, x in parts.items()}, name)
        arrays[name] = arr
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "file": f"shard_{host_id}.npz",
        }
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(directory, d, "_COMMITTED")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, target_tree, step: Optional[int] = None):
    """Restore into ``target_tree`` in place; returns ``(target_tree,
    step)``.

    Every tensor or array of the target is overwritten with its leaf (a
    module's parameters, moments, scalars), cast to its dtype, on its
    device; a leaf's shape must be the target's (a stacked ``blocks`` leaf:
    ``n_groups`` slices of the parameter's shape).  Leaves the target does
    not hold are ignored; a target leaf the checkpoint lacks raises
    ``KeyError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())

    files: Dict[str, Any] = {}
    try:
        for name, parts in _named_leaves(target_tree).items():
            if name not in manifest["leaves"]:
                raise KeyError(f"checkpoint missing leaf {name}")
            fname = manifest["leaves"][name]["file"]
            if fname not in files:
                files[fname] = np.load(os.path.join(path, fname))
            arr = files[fname][name]
            one = next(iter(parts.values()))
            want = tuple(one.shape) if None in parts else (len(parts),) + tuple(one.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {name}: checkpoint shape {arr.shape} != target {want}")
            for g, leaf in parts.items():
                value = arr if g is None else arr[g]
                if isinstance(leaf, torch.Tensor):
                    with torch.no_grad():
                        leaf.copy_(torch.from_numpy(np.array(value)))
                else:
                    leaf[...] = value
    finally:
        for f in files.values():
            f.close()
    return target_tree, step
