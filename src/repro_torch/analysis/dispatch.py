"""Dispatch checker — the port's counterpart of the reference's jit-hygiene
rules (``repro/analysis/jit.py``), stated for eager PyTorch and the ctypes
kernels.

The reference's four rules guard ``jax.jit`` / AOT dispatch.  The port runs
eagerly and launches hand-written kernels through ``ctypes``, so its
counterparts are:

* ``host-sync`` — inside a function on the card's dispatch path
  (``CheckConfig.dispatch_surfaces``: the analyzer's surfaces, the helpers
  they run and the kernel wrappers), a call that waits for the card on a
  tensor: ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` of one,
  ``float()`` / ``int()`` / ``bool()`` of one, an ``if`` / ``while`` that
  branches on one, or ``synchronize()`` (``torch.cuda.synchronize()``, a
  stream's or an event's).  On the card each of these stalls the host until
  the stream drains — under the engine, a stream the attached program's
  step shares the card with.  Tensors are the parameters annotated as
  ``torch.Tensor`` (``Optional[torch.Tensor]`` too) and the names assigned
  from expressions that read them; metadata reads (``.shape``, ``.dim()``,
  ``.dtype``, ``.device``, ``.numel()``, ``len()``) are host values and end
  the taint, and ``is None`` / ``isinstance`` tests branch on none.  The
  plain versions (``kernels/ref.py``) take CPU tensors only, where
  there is no card to wait for.
* ``build-bypass`` — ``ctypes.CDLL`` (or ``ctypes.cdll.LoadLibrary``), or a
  subprocess that runs ``nvcc``, anywhere but ``kernels/build.py``.  The
  counterpart of ``.lower().compile()`` outside the ``AotDispatchCache``
  build convention: a library loaded around :func:`~repro_torch.kernels.
  build.load` escapes its cache (one load a process) and its counters
  (``nvcc_runs``, ``library_loads``), so
  :class:`~repro_torch.analysis.sanitize.RecompileSanitizer` cannot see a
  steady-state scope rebuild.
* ``f64`` — ``torch.float64`` / ``torch.double`` / ``"float64"`` /
  ``.double()`` inside the f32 kernel wrappers (every function of a
  ``kernels/*.py`` module but the plain versions'):
  it upcasts a kernel operand or doubles its bytes.  The analyzer's
  deliberate f64 accumulators (``core/analyzer.py``: ``_accumulator``,
  ``_host_sums``) sum on the host side of the kernels' results, outside
  that path, and are not flagged.

The reference's fourth rule, ``jit-donate``, has no eager counterpart:
PyTorch has no buffer donation (as ``core/aot.py`` says of
``install_persistent_cache``), and the steady-state invariant it protects —
no new device buffers a dispatch — is held at run time by
:class:`~repro_torch.analysis.sanitize.RecompileSanitizer` over
``AotDispatchCache.total_lowerings()``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .findings import Finding
from .framework import CheckConfig, Checker, SourceFile, register

__all__ = ["DispatchChecker"]

_CAST_BUILTINS = ("float", "int", "bool")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# reads that give host metadata without waiting for the card: they end the
# taint (x.shape[0] is a host int)
_STATIC_ATTRS = (
    "shape", "ndim", "dtype", "device", "size", "dim", "numel", "is_cuda",
    "is_contiguous", "stride", "layout", "requires_grad", "is_pinned",
    "data_ptr", "element_size", "nbytes", "itemsize", "is_floating_point",
    "type",
)
_HOST_CALLS = ("len", "isinstance", "callable", "hasattr", "id")
_SUBPROCESS_CALLS = ("run", "Popen", "call", "check_call", "check_output", "system")
# the one file that may run nvcc or load a library
_BUILD_FILE = "kernels/build.py"
# the plain versions: they run on CPU tensors only (no card to wait for) and
# accumulate per-host sums in f64 as the analyzer does, so neither host-sync
# nor f64 applies there
_PLAIN_FILE = "kernels/ref.py"


def _func_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    for n in ast.walk(ann):
        if isinstance(n, ast.Attribute) and n.attr == "Tensor":
            return True
        if isinstance(n, ast.Name) and n.id == "Tensor":
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and "Tensor" in n.value:
            return True
    return False


def _mentions(node: ast.AST, names: Set[str]) -> bool:
    """True when ``node`` reads a tensor name through a path that is not
    host metadata (``x.shape[0]``, ``len(x)``).  A comprehension over
    tensors binds its targets to tensors and reads what its element reads:
    ``any(t.data_ptr() % 16 for t in (q, k))`` reads none."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Name) and n.id in names:
            return True
        if isinstance(n, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)):
            local = set(names)
            for gen in n.generators:
                if _mentions(gen.iter, local):
                    local |= {t.id for t in ast.walk(gen.target) if isinstance(t, ast.Name)}
                if any(_mentions(c, local) for c in gen.ifs):
                    return True
            parts = [n.key, n.value] if isinstance(n, ast.DictComp) else [n.elt]
            if any(_mentions(e, local) for e in parts):
                return True
            continue
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            continue
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)
            and n.func.id in _HOST_CALLS
        ):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def _reads_value(test: ast.AST, names: Set[str]) -> bool:
    """Whether a branch's test reads a tensor's value: tests on identity
    (``x is None``) read none, and each operand of ``and`` / ``or`` /
    ``not`` is judged on its own."""
    if isinstance(test, ast.BoolOp):
        return any(_reads_value(v, names) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _reads_value(test.operand, names)
    if isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
    ):
        return False
    return _mentions(test, names)


def _taint(fn: ast.FunctionDef) -> Set[str]:
    """Names (conservatively) holding tensors inside ``fn``: parameters
    annotated as tensors (of ``fn`` and of the functions nested in it), and
    forward through assignments and ``for`` targets to a fixpoint."""
    tainted: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            a = sub.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                if _is_tensor_annotation(arg.annotation):
                    tainted.add(arg.arg)
    for _ in range(10):
        changed = False
        for n in ast.walk(fn):
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value, targets = n.value, (
                    n.targets if isinstance(n, ast.Assign) else [n.target]
                )
            elif isinstance(n, ast.For):
                value, targets = n.iter, [n.target]
            else:
                continue
            if value is None or not _mentions(value, tainted):
                continue
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name) and leaf.id not in tainted:
                        tainted.add(leaf.id)
                        changed = True
        if not changed:
            break
    return tainted


def _is_f64(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr in ("float64", "double"):
        return isinstance(node.value, ast.Name) and node.value.id in (
            "torch", "np", "numpy",
        )
    if isinstance(node, ast.Constant) and node.value == "float64":
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "double"
        and not node.args
    )


def _is_kernel_module(sf: SourceFile) -> bool:
    parts = sf.rel.replace("\\", "/").split("/")
    return len(parts) >= 2 and parts[-2] == "kernels"


def _is_file(sf: SourceFile, suffix: str) -> bool:
    """Whether the file's repo-relative path ends in ``suffix``."""
    return ("/" + sf.rel.replace("\\", "/")).endswith("/" + suffix)


@register
class DispatchChecker(Checker):
    name = "dispatch"
    rules = ("host-sync", "build-bypass", "f64")

    def check_file(
        self, sf: SourceFile, config: CheckConfig
    ) -> Iterable[Finding]:
        findings: List[Finding] = []
        plain = _is_file(sf, _PLAIN_FILE)
        functions = [
            n for n in ast.walk(sf.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        if not plain:
            for fn in functions:
                if fn.name in config.dispatch_surfaces:
                    findings.extend(self._host_syncs(sf, fn))
        if not _is_file(sf, _BUILD_FILE):
            findings.extend(self._bypasses(sf))
        if _is_kernel_module(sf) and not plain:
            seen: Set[int] = set()
            for fn in functions:
                for n in ast.walk(fn):
                    if id(n) in seen or not _is_f64(n):
                        continue
                    seen.add(id(n))
                    findings.append(sf.finding(
                        n, "f64",
                        f"f64 inside the f32 kernel wrapper '{fn.name}': it "
                        "upcasts a kernel operand or doubles its bytes "
                        "(accumulate in f64 after the kernel, as the analyzer "
                        "does)",
                        checker=self.name,
                    ))
        return findings

    def _host_syncs(self, sf: SourceFile, fn: ast.FunctionDef) -> List[Finding]:
        tainted = _taint(fn)
        where = f"dispatch surface '{fn.name}'"
        out: List[Finding] = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                fname = _func_name(n)
                base = n.func.value if isinstance(n.func, ast.Attribute) else None
                if fname == "synchronize":
                    out.append(sf.finding(
                        n, "host-sync",
                        f"synchronize() inside {where} waits for the card",
                        checker=self.name,
                    ))
                elif fname in _SYNC_METHODS and base is not None and _mentions(base, tainted):
                    out.append(sf.finding(
                        n, "host-sync",
                        f".{fname}() of a tensor inside {where} waits for "
                        "the card (a device-to-host copy)",
                        checker=self.name,
                    ))
                elif (
                    isinstance(n.func, ast.Name)
                    and n.func.id in _CAST_BUILTINS
                    and any(_mentions(a, tainted) for a in n.args)
                ):
                    out.append(sf.finding(
                        n, "host-sync",
                        f"{n.func.id}() of a tensor inside {where} waits for "
                        "the card to read its value",
                        checker=self.name,
                    ))
            elif isinstance(n, (ast.If, ast.While)):
                if _reads_value(n.test, tainted):
                    out.append(sf.finding(
                        n.test, "host-sync",
                        f"branching on a tensor's value inside {where} waits "
                        "for the card; use torch.where (or decide on the host "
                        "before dispatch)",
                        checker=self.name,
                    ))
        return out

    def _bypasses(self, sf: SourceFile) -> List[Finding]:
        out: List[Finding] = []
        for n in ast.walk(sf.tree):
            if not isinstance(n, ast.Call):
                continue
            fname = _func_name(n)
            f = n.func
            loads = (
                fname in ("CDLL", "PyDLL")
                or (fname == "LoadLibrary" and isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Attribute) and f.value.attr == "cdll")
            )
            if loads:
                out.append(sf.finding(
                    n, "build-bypass",
                    f"{fname}() outside kernels/build.py loads a library around "
                    "build.load's cache and counters; route it through "
                    "repro_torch.kernels.build.load",
                    checker=self.name,
                ))
            elif fname in _SUBPROCESS_CALLS and any(
                (isinstance(a, ast.Constant) and isinstance(a.value, str) and "nvcc" in a.value)
                or (isinstance(a, ast.Call) and _func_name(a) == "_nvcc")
                for arg in list(n.args) + [kw.value for kw in n.keywords]
                for a in ast.walk(arg)
            ):
                out.append(sf.finding(
                    n, "build-bypass",
                    "an nvcc run outside kernels/build.py bypasses its build "
                    "cache and the nvcc_runs counter the recompile sanitizer "
                    "reads; route it through repro_torch.kernels.build.build",
                    checker=self.name,
                ))
        return out
