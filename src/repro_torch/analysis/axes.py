"""simdim axes checker — named-axis shape contracts over the port's dispatch
surfaces (the port's copy of ``repro/analysis/axes.py``, in PyTorch's idiom).

:func:`repro_torch.annotations.axes` makes the ``[B,N]`` / ``[K,B,N]`` /
``[S,H,C]`` axis conventions of the analyzer's surfaces and the kernel
entry points declarations; this checker makes them *checked*:

* ``axes-missing`` — a dispatch-surface function named in
  ``CheckConfig.axes_required`` carries no ``@axes(...)`` decorator.
* ``axes-mismatch`` — a call site passes an argument whose tracked axis
  spec is a *permutation* of the contract's (``[N,B]`` into a ``[B,N]``
  parameter — the transposed-dispatch bug), or binds one contract axis to
  two different caller axes across the call's arguments.
* ``axes-rank`` — a call site passes an argument whose tracked rank
  contradicts the contract, or a reduction names a constant dimension
  outside the operand's tracked rank.

Axis specs are tracked flow-sensitively inside each function: parameters
of ``@axes``-decorated functions seed the environment, and specs propagate
through assignment, ``permute`` / ``transpose`` (PyTorch's two-dimension
swap, ``swapaxes``, ``.mT``, and the reference's permutation forms
``jnp.transpose(x, perm)`` / ``.T``), ``unsqueeze``, reductions with a
constant ``dim=`` / ``axis=`` (an int, a tuple or the positional form; the
dimensions dropped, or kept as ``_`` under ``keepdim=True``), elementwise
arithmetic (a number broadcasts as a scalar), dtype and device moves,
indexing (``None``, ``...``, slices and integers), and ``torch.vmap`` — a
``vmap(one, in_dims=...)(*xs)`` call peels the mapped dimension off every
argument spec and analyzes the *closure* ``one`` under the peeled bindings,
so a contract violation buried in a vmapped helper still surfaces at the
innermost call site.  ``max`` / ``min`` / ``median`` / ``cummax`` with a
dimension return a (values, indices) pair in PyTorch, so tracking ends
there, as it does at ``reshape`` / ``view`` / ``expand``.  Renaming is
legal (a sweep may pass ``G`` where a callee says ``K``); only bindings
*inconsistent within one call* or using the callee's own vocabulary at the
wrong position are errors — the transposition class — which keeps the
checker quiet on legitimately generic callers.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import Finding
from .framework import CheckConfig, Checker, SourceFile, register

__all__ = ["AxesChecker"]

Spec = Tuple[str, ...]  # axis tokens, e.g. ("K", "B", "N"); "_" = wildcard

_REDUCERS = {
    "sum", "max", "min", "mean", "prod", "argmax", "argmin", "any", "all",
    "median", "std", "var", "cummax", "cumsum",
    # PyTorch's spellings
    "amax", "amin", "nansum", "nanmean", "logsumexp", "count_nonzero",
    "cumprod", "cummin",
}
_CUMULATIVE = {"cummax", "cumsum", "cumprod", "cummin"}  # shape-preserving
# with a dimension these return (values, indices) in PyTorch
_PAIR_WITH_DIM = {"max", "min", "median", "cummax", "cummin"}
_SEGMENT_OPS = {"segment_sum", "segment_max", "segment_min", "segment_prod"}
_ELEMENTWISE = {
    "where", "maximum", "minimum", "abs", "exp", "log", "sqrt", "clip",
    "astype", "asarray", "array", "copy", "nan_to_num",
    # PyTorch's spellings
    "clamp", "clone", "detach", "contiguous", "sigmoid", "relu", "neg",
    "floor", "ceil", "round", "sign", "masked_fill",
}
# methods that keep their receiver's shape whatever their arguments (a
# dtype or device move, a fill): x.to(torch.int64) is x's spec
_SAME_SHAPE_METHODS = {
    "to", "float", "double", "int", "long", "bool", "half", "bfloat16",
    "contiguous", "clone", "detach", "cpu", "cuda", "masked_fill", "clamp",
    "clip", "type_as", "nan_to_num", "abs", "neg", "sqrt", "exp", "log",
    "astype",
}
_SWAPS = {"swapaxes", "swapdims"}
_PERM_MODULES = ("jnp", "np", "numpy")  # transpose(x, perm): a permutation


def _is_number(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
        and not isinstance(node.value, bool)
    )


def _parse_decorator(dec: ast.expr) -> Optional[Tuple[List[Spec], Dict[str, Spec]]]:
    """``@axes("K,B,N", stts="K,S")`` -> positional + keyword token specs."""
    if not isinstance(dec, ast.Call):
        return None
    name = dec.func.attr if isinstance(dec.func, ast.Attribute) else (
        dec.func.id if isinstance(dec.func, ast.Name) else None
    )
    if name != "axes":
        return None
    pos: List[Spec] = []
    kw: Dict[str, Spec] = {}
    for a in dec.args:
        if not (isinstance(a, ast.Constant) and isinstance(a.value, str)):
            return None
        pos.append(_parse_spec(a.value))
    for k in dec.keywords:
        if k.arg is None or not (
            isinstance(k.value, ast.Constant) and isinstance(k.value.value, str)
        ):
            return None
        kw[k.arg] = _parse_spec(k.value.value)
    return pos, kw


def _parse_spec(s: str) -> Spec:
    return tuple(t.strip() for t in s.split(",")) if s.strip() else ()


def _positional_params(fn: ast.FunctionDef) -> List[str]:
    return [a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args)]


class Contract:
    """One function's declared axis contract, keyed by parameter name."""

    def __init__(self, fn: ast.FunctionDef, pos: List[Spec], kw: Dict[str, Spec]):
        self.params = _positional_params(fn)
        self.specs: Dict[str, Spec] = dict(zip(self.params, pos))
        self.specs.update(kw)
        self.vocab = {t for spec in self.specs.values() for t in spec}

    def spec_for_arg(self, i: int) -> Optional[Spec]:
        if i < len(self.params):
            return self.specs.get(self.params[i])
        return None


def _collect_contracts(files: Sequence[SourceFile]) -> Dict[str, Contract]:
    out: Dict[str, Optional[Contract]] = {}
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            for dec in node.decorator_list:
                parsed = _parse_decorator(dec)
                if parsed is None:
                    continue
                c = Contract(node, *parsed)
                # same name declared twice with different specs: ambiguous
                if node.name in out and (
                    out[node.name] is None or out[node.name].specs != c.specs
                ):
                    out[node.name] = None
                else:
                    out[node.name] = c
    return {k: v for k, v in out.items() if v is not None}


# --------------------------------------------------------------------------- #
# per-function spec tracking


class _FuncWalk:
    def __init__(
        self,
        sf: SourceFile,
        fn: ast.FunctionDef,
        contracts: Dict[str, Contract],
        findings: List[Finding],
        checker: str,
        seed: Optional[Dict[str, Spec]] = None,
        depth: int = 0,
    ):
        self.sf = sf
        self.fn = fn
        self.contracts = contracts
        self.findings = findings
        self.checker = checker
        self.depth = depth
        self._checked: set = set()
        self.env: Dict[str, Optional[Spec]] = {}
        self.tuples: Dict[str, List[ast.expr]] = {}  # name -> tuple literal elts
        self.local_fns: Dict[str, ast.FunctionDef] = {}
        own = _own_contract(fn)
        for p in _positional_params(fn):
            self.env[p] = None
        if own is not None:
            for p, spec in own.specs.items():
                self.env[p] = spec
        if seed:
            self.env.update(seed)

    def _find(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(self.sf.finding(node, rule, msg, self.checker))

    # -- spec inference --------------------------------------------------- #

    def spec_of(self, node: ast.AST) -> Optional[Spec]:  # noqa: C901
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Starred):
            return self.spec_of(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.spec_of(node.operand)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, (ast.MatMult, ast.Pow)):
                return None
            a, b = self._operand(node.left), self._operand(node.right)
            if a is None or b is None:
                return None  # unknown side may broadcast to any rank
            if len(a) == len(b):
                return a  # elementwise; renamings are legal, keep left
            return a if len(a) > len(b) else b  # right-aligned broadcast
        if isinstance(node, ast.IfExp):
            a, b = self.spec_of(node.body), self.spec_of(node.orelse)
            if a is not None and b is not None and len(a) == len(b):
                return a
            return None
        if isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                self.spec_of(e)
            return None
        if isinstance(node, ast.Subscript):
            return self._subscript(node)
        if isinstance(node, ast.Call):
            return self._call_spec(node)
        if isinstance(node, ast.Attribute):
            base = self.spec_of(node.value) if node.attr in ("T", "mT") else None
            if base is None:
                return None
            if node.attr == "T":
                return tuple(reversed(base))
            if len(base) >= 2:  # .mT: the last two dimensions swapped
                return base[:-2] + (base[-1], base[-2])
            return None
        return None

    def _operand(self, node: ast.AST) -> Optional[Spec]:
        """An elementwise operand's spec: a number is a scalar that
        broadcasts (``[]``)."""
        if _is_number(node):
            return ()
        return self.spec_of(node)

    def _subscript(self, node: ast.Subscript) -> Optional[Spec]:
        base = self.spec_of(node.value)
        if base is None:
            return None
        idx = node.slice
        items = list(idx.elts) if isinstance(idx, ast.Tuple) else [idx]
        # an Ellipsis stands for every dimension no other item consumes
        consumed = sum(
            1 for it in items
            if isinstance(it, ast.Slice)
            or (isinstance(it, ast.Constant) and isinstance(it.value, int))
        )
        out: List[str] = []
        pos = 0
        for it in items:
            if isinstance(it, ast.Slice):
                if pos < len(base):
                    out.append(base[pos])
                pos += 1
            elif isinstance(it, ast.Constant) and it.value is None:
                out.append("_")  # newaxis
            elif isinstance(it, ast.Constant) and it.value is Ellipsis:
                skip = max(len(base) - consumed, 0)
                out.extend(base[pos:pos + skip])
                pos += skip
            elif isinstance(it, ast.Constant) and isinstance(it.value, int):
                pos += 1  # static integer index: drops the dim
            else:
                # tensor/variable index is a *gather* (rank-preserving or
                # not) — tracking ends
                return None
        out.extend(base[pos:])
        return tuple(out)

    @staticmethod
    def _int_tuple(node: ast.AST) -> Optional[Tuple[int, ...]]:
        """An int constant, or a tuple/list of them, as a tuple."""
        elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) else [node]
        out = []
        for e in elts:
            if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub) \
                    and isinstance(e.operand, ast.Constant):
                e = ast.Constant(-e.operand.value)
            if not (isinstance(e, ast.Constant) and isinstance(e.value, int)
                    and not isinstance(e.value, bool)):
                return None
            out.append(e.value)
        return tuple(out)

    def _reduce_dims(self, call: ast.Call, method_form: bool):
        """The reduction's dimensions: ``("all", None)`` when none is given,
        ``("const", dims)`` for constant ones (``axis=`` / ``dim=`` / the
        positional form, an int or a tuple), ``("unknown", None)`` else."""
        for kw in call.keywords:
            if kw.arg in ("axis", "dim"):
                dims = self._int_tuple(kw.value)
                return ("const", dims) if dims is not None else ("unknown", None)
        pos = call.args if method_form else call.args[1:]
        if pos:
            dims = self._int_tuple(pos[0])
            return ("const", dims) if dims is not None else ("unknown", None)
        return ("all", None)

    def _keepdims(self, call: ast.Call) -> bool:
        return any(
            kw.arg in ("keepdims", "keepdim")
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in call.keywords
        )

    def _call_spec(self, node: ast.Call) -> Optional[Spec]:  # noqa: C901
        self.check_call(node)
        func = node.func
        fname = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        recv = func.value if isinstance(func, ast.Attribute) else None
        module = recv.id if isinstance(recv, ast.Name) and recv.id not in self.env else None

        recv_spec = self.spec_of(recv) if recv is not None else None
        method_form = recv_spec is not None
        if method_form:
            base, rest = recv_spec, list(node.args)
        elif recv is None or module is not None:  # torch.sum(x, 1), f(x)
            base = self.spec_of(node.args[0]) if node.args else None
            rest = list(node.args[1:])
        else:  # a method of an untracked receiver
            base, rest = None, list(node.args)

        if fname in ("transpose", "permute", "t") or fname in _SWAPS:
            if base is None:
                return None
            dims = None
            if len(rest) == 1:
                dims = self._int_tuple(rest[0])
            elif rest:
                dims = self._int_tuple(ast.Tuple(elts=list(rest)))
            if fname == "t" or (fname == "transpose" and not rest):
                return tuple(reversed(base))
            swap = fname in _SWAPS or (
                fname == "transpose" and len(rest) == 2 and module not in _PERM_MODULES
            )
            if dims is None:
                return None
            if swap:  # PyTorch's transpose(a, b): two dimensions exchanged
                if len(dims) != 2 or not all(-len(base) <= d < len(base) for d in dims):
                    self._find(
                        node, "axes-rank",
                        f"{fname}{dims} does not fit tracked axes "
                        f"[{','.join(base)}]",
                    )
                    return None
                a, b = (d % len(base) for d in dims)
                out = list(base)
                out[a], out[b] = out[b], out[a]
                return tuple(out)
            perm = tuple(d + len(base) if -len(base) <= d < 0 else d for d in dims)
            if len(perm) != len(base) or sorted(perm) != list(range(len(base))):
                self._find(
                    node, "axes-rank",
                    f"{fname} permutation {dims} does not fit tracked "
                    f"axes [{','.join(base)}]",
                )
                return None
            return tuple(base[i] for i in perm)

        if fname == "unsqueeze" and base is not None and rest:
            dims = self._int_tuple(rest[0])
            if dims is None or len(dims) != 1 or not -len(base) - 1 <= dims[0] <= len(base):
                return None
            d = dims[0] % (len(base) + 1)
            return base[:d] + ("_",) + base[d:]

        if fname in _REDUCERS:
            if base is None:
                return None
            kind, dims = self._reduce_dims(node, method_form)
            if kind == "unknown":
                return None
            if fname in _PAIR_WITH_DIM and kind == "const" and not any(
                kw.arg == "axis" for kw in node.keywords
            ):
                return None  # PyTorch's (values, indices)
            if fname in _CUMULATIVE:
                return base
            if kind == "all":
                return ()
            for ax in dims:
                if not -len(base) <= ax < len(base):
                    self._find(
                        node, "axes-rank",
                        f"{fname}(axis={ax}) out of range for tracked axes "
                        f"[{','.join(base)}] (rank {len(base)})",
                    )
                    return None
            drop = {ax % len(base) for ax in dims}
            if self._keepdims(node):
                return tuple("_" if i in drop else a for i, a in enumerate(base))
            return tuple(a for i, a in enumerate(base) if i not in drop)

        if fname in _SEGMENT_OPS and node.args:
            base = self.spec_of(node.args[0])
            return ("_",) + base[1:] if base else None

        if method_form and fname in _SAME_SHAPE_METHODS:
            return recv_spec

        if fname in _ELEMENTWISE:
            if fname == "where" and len(node.args) == 3:
                a = self._operand(node.args[1])
                b = self._operand(node.args[2])
                if a is None or b is None:
                    return None
                return a if len(a) >= len(b) else b
            if recv_spec is not None and not node.args:
                return recv_spec
            if node.args:
                return self.spec_of(node.args[0])
            return None

        return None  # reshape / view / expand / flatten: tracking ends

    # -- contract checking at call sites ----------------------------------- #

    def check_call(self, node: ast.Call) -> None:
        if id(node) in self._checked:
            return
        self._checked.add(id(node))
        func = node.func
        fname = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        if fname in ("vmap",):
            return  # handled by the caller of vmap's result
        contract = self.contracts.get(fname or "")
        if contract is not None:
            self._check_against(node, fname, contract)

    def _check_against(self, node: ast.Call, fname: str, c: Contract) -> None:
        binding: Dict[str, str] = {}
        reverse: Dict[str, str] = {}
        args: List[Tuple[Optional[Spec], Optional[Spec], str]] = []
        flat: List[ast.expr] = []
        for a in node.args:
            if isinstance(a, ast.Starred):
                inner = self._tuple_elts(a.value)
                if inner is None:
                    return  # unknown expansion: cannot line up positions
                flat.extend(inner)
            else:
                flat.append(a)
        for i, a in enumerate(flat):
            args.append((c.spec_for_arg(i), self.spec_of(a), f"arg {i}"))
        for kw in node.keywords:
            if kw.arg is not None and kw.arg in c.specs:
                args.append((c.specs[kw.arg], self.spec_of(kw.value), kw.arg))

        for want, got, label in args:
            if want is None or got is None:
                continue
            if len(want) != len(got):
                self._find(
                    node, "axes-rank",
                    f"{fname}() {label}: contract [{','.join(want)}] is rank "
                    f"{len(want)} but tracked value is [{','.join(got)}] "
                    f"(rank {len(got)})",
                )
                continue
            for pos, (w, g) in enumerate(zip(want, got)):
                if w == "_" or g == "_" or w.isdigit() or g.isdigit():
                    continue
                if w == g:
                    binding.setdefault(w, g)
                    reverse.setdefault(g, w)
                    continue
                # caller speaks the contract's own vocabulary but at the
                # wrong position: the transposition class
                if g in c.vocab:
                    self._find(
                        node, "axes-mismatch",
                        f"{fname}() {label}: axis {pos} is {g!r} but the "
                        f"contract wants {w!r} ([{','.join(want)}]) — "
                        "transposed dispatch?",
                    )
                    break
                if binding.get(w, g) != g or reverse.get(g, w) != w:
                    self._find(
                        node, "axes-mismatch",
                        f"{fname}() {label}: contract axis {w!r} binds both "
                        f"{binding.get(w, reverse.get(g))!r} and {g!r} in one "
                        "call — inconsistent dispatch",
                    )
                    break
                binding[w] = g
                reverse[g] = w

    def _tuple_elts(self, node: ast.expr) -> Optional[List[ast.expr]]:
        if isinstance(node, (ast.Tuple, ast.List)):
            return list(node.elts)
        if isinstance(node, ast.Name) and node.id in self.tuples:
            return self.tuples[node.id]
        return None

    # -- vmap closures ------------------------------------------------------ #

    def _maybe_vmap_call(self, node: ast.Call) -> bool:
        """``vmap(one, in_dims=...)(args)``: peel each argument's mapped
        dimension (0 by default; ``None`` leaves it unmapped) and analyze
        the closure ``one`` under the peeled bindings."""
        inner = node.func
        if not isinstance(inner, ast.Call):
            return False
        iname = inner.func.attr if isinstance(inner.func, ast.Attribute) else (
            inner.func.id if isinstance(inner.func, ast.Name) else None
        )
        if iname != "vmap" or not inner.args:
            return False
        target = inner.args[0]
        if not isinstance(target, ast.Name):
            return False
        fn = self.local_fns.get(target.id)
        if fn is None or self.depth >= 4:
            return True  # it *was* a vmap call, just not analyzable
        in_dims: Optional[ast.expr] = inner.args[1] if len(inner.args) > 1 else None
        for kw in inner.keywords:
            if kw.arg == "in_dims":
                in_dims = kw.value
        flat: List[ast.expr] = []
        for a in node.args:
            if isinstance(a, ast.Starred):
                elts = self._tuple_elts(a.value)
                if elts is None:
                    return True
                flat.extend(elts)
            else:
                flat.append(a)
        if in_dims is None:
            mapped: List[Optional[int]] = [0] * len(flat)
        elif isinstance(in_dims, ast.Constant) and isinstance(in_dims.value, int):
            mapped = [in_dims.value] * len(flat)
        elif isinstance(in_dims, (ast.Tuple, ast.List)) and len(in_dims.elts) == len(flat):
            mapped = []
            for e in in_dims.elts:
                if isinstance(e, ast.Constant) and (e.value is None or isinstance(e.value, int)):
                    mapped.append(e.value)
                else:
                    return True
        else:
            return True
        params = _positional_params(fn)
        seed: Dict[str, Spec] = {}
        for p, a, d in zip(params, flat, mapped):
            spec = self.spec_of(a)
            if spec and d is None:
                seed[p] = spec
            elif spec and -len(spec) <= d < len(spec):
                d %= len(spec)
                seed[p] = spec[:d] + spec[d + 1:]
        sub = _FuncWalk(
            self.sf, fn, self.contracts, self.findings, self.checker,
            seed=seed, depth=self.depth + 1,
        )
        sub.local_fns.update(self.local_fns)
        sub.run()
        return True

    # -- statement walk ----------------------------------------------------- #

    def run(self) -> None:
        self._block(self.fn.body)

    def _block(self, stmts: Sequence[ast.stmt]) -> None:  # noqa: C901
        for st in stmts:
            if isinstance(st, ast.FunctionDef):
                self.local_fns[st.name] = st
                continue  # analyzed when vmapped/called, with real seeds
            if isinstance(st, ast.Assign):
                self._visit_value(st.value)
                spec = self.spec_of(st.value)
                for tgt in st.targets:
                    if isinstance(tgt, ast.Name):
                        self.env[tgt.id] = spec
                        if isinstance(st.value, (ast.Tuple, ast.List)):
                            self.tuples[tgt.id] = list(st.value.elts)
                    elif isinstance(tgt, (ast.Tuple, ast.List)):
                        for e in tgt.elts:
                            if isinstance(e, ast.Name):
                                self.env[e.id] = None
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._visit_value(st.value)
                if isinstance(st.target, ast.Name):
                    self.env[st.target.id] = self.spec_of(st.value)
            elif isinstance(st, ast.AugAssign):
                self._visit_value(st.value)
            elif isinstance(st, (ast.Return, ast.Expr)):
                if getattr(st, "value", None) is not None:
                    self._visit_value(st.value)
                    self.spec_of(st.value)  # reduction-rank checks fire here
            elif isinstance(st, (ast.If, ast.While)):
                self._visit_value(st.test)
                self._block(st.body)
                self._block(st.orelse)
            elif isinstance(st, ast.For):
                self._visit_value(st.iter)
                if isinstance(st.target, ast.Name):
                    self.env[st.target.id] = None
                self._block(st.body)
                self._block(st.orelse)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self._visit_value(item.context_expr)
                self._block(st.body)
            elif isinstance(st, ast.Try):
                self._block(st.body)
                for h in st.handlers:
                    self._block(h.body)
                self._block(st.orelse)
                self._block(st.finalbody)

    def _visit_value(self, node: ast.AST) -> None:
        """Check every call in the expression (vmap closures included)."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                if self._maybe_vmap_call(sub):
                    continue
                self.check_call(sub)


def _own_contract(fn: ast.FunctionDef) -> Optional[Contract]:
    for dec in fn.decorator_list:
        parsed = _parse_decorator(dec)
        if parsed is not None:
            return Contract(fn, *parsed)
    return None


# --------------------------------------------------------------------------- #


@register
class AxesChecker(Checker):
    """Named-axis contract checking (see module docstring)."""

    name = "axes"
    rules = ("axes-missing", "axes-mismatch", "axes-rank")

    def check_repo(
        self, files: Sequence[SourceFile], root: Path, config: CheckConfig
    ) -> Iterable[Finding]:
        contracts = _collect_contracts(files)
        findings: List[Finding] = []

        for sf in files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.FunctionDef):
                    continue
                if (
                    node.name in config.axes_required
                    and _own_contract(node) is None
                ):
                    findings.append(
                        sf.finding(
                            node,
                            "axes-missing",
                            f"dispatch surface {node.name}() must declare "
                            "its axis contract with @annotations.axes(...)",
                            self.name,
                        )
                    )

        # flow-sensitive walk of every module-level function and method
        for sf in files:
            for node in sf.tree.body:
                fns: List[ast.FunctionDef] = []
                if isinstance(node, ast.FunctionDef):
                    fns.append(node)
                elif isinstance(node, ast.ClassDef):
                    fns.extend(
                        n for n in node.body if isinstance(n, ast.FunctionDef)
                    )
                for fn in fns:
                    walk = _FuncWalk(sf, fn, contracts, findings, self.name)
                    walk.run()
        return findings
