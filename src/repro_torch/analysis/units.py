"""simdim units checker — flow-sensitive physical-unit abstract interpretation
(the port's copy of ``repro/analysis/units.py``).

The port's unit discipline is the reference's: ``_ns`` names hold
nanoseconds, ``_s`` seconds, ``_bytes`` bytes, ``_gbps`` GB/s (== bytes/ns —
the 1e9 cancels, see ``core/topology.py``), and every scale change routes
through :mod:`repro_torch.core.units`.  This checker turns the convention
into rules:

* ``unit-mismatch`` — an add/sub/compare/assign whose two sides carry
  *different known* units (``lat_ns + win_s``, ``if t_ns < budget_s:``),
  or a conversion helper applied to the wrong input unit
  (``ns_to_s(latency_s)``).
* ``unit-return`` — a ``return`` whose expression's inferred unit
  contradicts the function's own name suffix (``def window_ns(...):
  return span_s``).
* ``unit-raw-conversion`` — a bare ``* 1e9``-family literal multiplied or
  divided against a value with a known unit anywhere outside
  ``repro_torch/core/units.py``: the named helpers are the only legal
  conversion points.

The abstract domain is a symbol fraction (``byte/ns`` for link rates,
``ns`` for clocks, ``1`` for dimensionless) so ordinary bandwidth math
checks out with **no annotations at all**: ``wbytes / bw_gbps`` is
``byte / (byte/ns) = ns``.  Units seed from name suffixes, from
:func:`repro_torch.annotations.unit` markers, and from the
:mod:`repro_torch.core.units` constants (``NS_PER_S`` is ``ns/s``); they
flow through assignments, arithmetic, known pass-through calls (``sum``,
``.cumsum()``, ``where``, and PyTorch's ``clamp``, ``.to(...)``,
``.contiguous()``), and user calls via interprocedural summaries (a
fixpoint over every function's inferred return unit, merged with its name
suffix).  Unknown values stay unknown — the checker only speaks when *both*
sides of an operation are known, which is what keeps it quiet on untyped
code.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import Finding
from .framework import CheckConfig, Checker, SourceFile, register

__all__ = ["UnitsChecker"]

# --------------------------------------------------------------------------- #
# the unit algebra: a reduced fraction over base symbols

Unit = Tuple[Tuple[str, ...], Tuple[str, ...]]  # (numerator, denominator)

ONE: Unit = ((), ())


def _mk(num: Sequence[str] = (), den: Sequence[str] = ()) -> Unit:
    n, d = list(num), list(den)
    for sym in list(n):
        if sym in d:
            n.remove(sym)
            d.remove(sym)
    return (tuple(sorted(n)), tuple(sorted(d)))


def _mul(a: Unit, b: Unit) -> Unit:
    return _mk(a[0] + b[0], a[1] + b[1])


def _div(a: Unit, b: Unit) -> Unit:
    return _mk(a[0] + b[1], a[1] + b[0])


def _fmt(u: Unit) -> str:
    if u == ONE:
        return "1"
    num = "*".join(u[0]) or "1"
    return f"{num}/{'*'.join(u[1])}" if u[1] else num


NS = _mk(["ns"])
S = _mk(["s"])
MS = _mk(["ms"])
US = _mk(["us"])
BYTE = _mk(["byte"])
GIB = _mk(["gib"])
MIB = _mk(["mib"])
GBPS = _mk(["byte"], ["ns"])  # GB/s == bytes/ns, the repo link-rate unit

# name-suffix seeds (the declaration is the name)
_SUFFIX_UNITS: Dict[str, Unit] = {
    "_ns": NS,
    "_s": S,
    "_ms": MS,
    "_us": US,
    "_bytes": BYTE,
    "_gib": GIB,
    "_mib": MIB,
    "_gbps": GBPS,
    "_frac": ONE,
}
_EXACT_NAMES: Dict[str, Unit] = {"nbytes": BYTE, "wbytes": BYTE}

# repro.core.units constants carry conversion-factor units, so plain
# fraction algebra makes `x_s * NS_PER_S` come out as ns
_CONSTANT_UNITS: Dict[str, Unit] = {
    "NS_PER_S": _mk(["ns"], ["s"]),
    "S_PER_NS": _mk(["s"], ["ns"]),
    "NS_PER_MS": _mk(["ns"], ["ms"]),
    "NS_PER_US": _mk(["ns"], ["us"]),
    "MS_PER_S": _mk(["ms"], ["s"]),
    "BYTES_PER_GB": _mk(["byte"], ["gb"]),
    "BYTES_PER_GIB": _mk(["byte"], ["gib"]),
    "BYTES_PER_MIB": _mk(["byte"], ["mib"]),
}

# helper name -> (expected input unit or None, output unit)
_HELPERS: Dict[str, Tuple[Optional[Unit], Unit]] = {
    "ns_to_s": (NS, S),
    "s_to_ns": (S, NS),
    "s_to_ms": (S, MS),
    "ns_to_ms": (NS, MS),
    "ms_to_ns": (MS, NS),
    "ns_to_us": (NS, US),
    "us_to_ns": (US, NS),
    "gib_to_bytes": (GIB, BYTE),
    "bytes_to_gib": (BYTE, GIB),
    "mib_to_bytes": (MIB, BYTE),
    "bytes_to_mib": (BYTE, MIB),
    "gbps_to_bytes_per_s": (GBPS, _mk(["byte"], ["s"])),
}

# unit-string vocabulary for annotations.unit("...") markers
_UNIT_TOKENS: Dict[str, Unit] = {
    "ns": NS,
    "s": S,
    "ms": MS,
    "us": US,
    "bytes": BYTE,
    "byte": BYTE,
    "gib": GIB,
    "mib": MIB,
    "gbps": GBPS,
    "1": ONE,
}

# calls that return their (first) argument's unit unchanged
_PASS_THROUGH_FUNCS = {
    "abs", "float", "sum", "max", "min", "round", "sorted",
    "asarray", "array", "cumsum", "maximum", "minimum", "mean", "median",
    "sort", "concatenate", "stack", "abs", "unique", "ravel", "squeeze",
    "full_like", "zeros_like", "ones_like", "transpose", "reshape",
    "segment_sum", "segment_max", "cummax", "unit",
    # PyTorch's spellings
    "clamp", "amax", "amin", "cat",
}
# methods whose receiver's unit passes through
_PASS_THROUGH_METHODS = {
    "sum", "max", "min", "mean", "cumsum", "astype", "copy", "reshape",
    "ravel", "squeeze", "item", "tolist", "transpose", "clip", "get",
    # PyTorch's spellings (a dtype or device move keeps the unit)
    "to", "float", "double", "contiguous", "clone", "detach", "cpu", "numpy",
    "amax", "amin", "flatten", "permute",
}
# jnp.where(cond, a, b) unifies a/b; clip passes arg0
_SELECT_FUNCS = {"where"}

# the raw-conversion literal family (values, matched exactly)
_CONVERSION_LITERALS = {1e9, 1e-9, 1e6, 1e-6, 1e3, 1e-3, 2**30, 2**20}


def _is_conversion_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value) in _CONVERSION_LITERALS
    # the 2**30 / 2**20 spelled-out powers
    if (
        isinstance(node, ast.BinOp)
        and isinstance(node.op, ast.Pow)
        and isinstance(node.left, ast.Constant)
        and node.left.value == 2
        and isinstance(node.right, ast.Constant)
        and node.right.value in (20, 30)
    ):
        return True
    return False


def _is_scalar_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        return _is_scalar_literal(node.operand)
    return False


def _seed_for(name: str) -> Optional[Unit]:
    if name in _EXACT_NAMES:
        return _EXACT_NAMES[name]
    if name in _CONSTANT_UNITS:
        return _CONSTANT_UNITS[name]
    for suf, u in _SUFFIX_UNITS.items():
        if name.endswith(suf) and len(name) > len(suf):
            return u
    return None


def _final_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


# --------------------------------------------------------------------------- #
# per-function flow-sensitive interpreter


class _FuncAnalysis:
    def __init__(
        self,
        sf: SourceFile,
        fn: ast.FunctionDef,
        summaries: Dict[str, Optional[Unit]],
        emit: Optional[List[Finding]],
        checker_name: str,
        exempt_conversions: bool,
        outer_env: Optional[Dict[str, Optional[Unit]]] = None,
    ):
        self.sf = sf
        self.fn = fn
        self.summaries = summaries
        self.emit = emit  # None: inference-only pass (no findings)
        self.checker = checker_name
        self.exempt_conversions = exempt_conversions
        self.env: Dict[str, Optional[Unit]] = dict(outer_env or {})
        for a in list(fn.args.posonlyargs) + list(fn.args.args) + list(
            fn.args.kwonlyargs
        ):
            self.env[a.arg] = _seed_for(a.arg)
        self.return_units: List[Optional[Unit]] = []

    # -- findings -------------------------------------------------------- #

    def _find(self, node: ast.AST, rule: str, msg: str) -> None:
        if self.emit is not None:
            self.emit.append(self.sf.finding(node, rule, msg, self.checker))

    # -- expression units ------------------------------------------------- #

    def unit_of(self, node: ast.AST) -> Optional[Unit]:  # noqa: C901
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            return _seed_for(node.id)
        if isinstance(node, ast.Attribute):
            return _seed_for(node.attr)
        if isinstance(node, ast.Subscript):
            return self.unit_of(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.unit_of(node.operand)
        if isinstance(node, ast.IfExp):
            self.unit_of(node.test)
            return self._unify(node, self.unit_of(node.body), self.unit_of(node.orelse))
        if isinstance(node, ast.Compare):
            u = self.unit_of(node.left)
            for op, right in zip(node.ops, node.comparators):
                v = self.unit_of(right)
                if (
                    isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq))
                    and u is not None
                    and v is not None
                    and u != v
                ):
                    self._find(
                        node,
                        "unit-mismatch",
                        f"comparison of {_fmt(u)} against {_fmt(v)}",
                    )
                u = v
            return None  # bool
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self.unit_of(v)
            return None
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                self.unit_of(e)
            return None
        if isinstance(node, ast.Starred):
            return self.unit_of(node.value)
        if isinstance(node, ast.NamedExpr):
            u = self.unit_of(node.value)
            self.env[node.target.id] = u
            return u
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in node.generators:
                self.unit_of(gen.iter)
            return self.unit_of(node.elt)
        return None

    def _unify(
        self, node: ast.AST, a: Optional[Unit], b: Optional[Unit]
    ) -> Optional[Unit]:
        if a is not None and b is not None and a != b:
            self._find(
                node, "unit-mismatch", f"mixing {_fmt(a)} with {_fmt(b)}"
            )
            return None
        return a if a is not None else b

    def _binop(self, node: ast.BinOp) -> Optional[Unit]:
        u = self.unit_of(node.left)
        v = self.unit_of(node.right)
        op = node.op
        if isinstance(op, (ast.Add, ast.Sub)):
            return self._unify(node, u, v)
        if isinstance(op, (ast.Mult, ast.Div, ast.FloorDiv)):
            # a bare conversion literal against a united value: the one
            # illegal form.  Routed conversions use repro.core.units.
            for lit, other, other_unit in (
                (node.right, node.left, u),
                (node.left, node.right, v),
            ):
                if (
                    not self.exempt_conversions
                    and _is_conversion_literal(lit)
                    and other_unit is not None
                    and other_unit != ONE
                ):
                    self._find(
                        node,
                        "unit-raw-conversion",
                        f"raw conversion literal "
                        f"{ast.unparse(lit)} applied to a {_fmt(other_unit)} "
                        "value; route it through repro_torch.core.units "
                        "(ns_to_s, NS_PER_S, ...)",
                    )
                    return None
            if u is None and _is_scalar_literal(node.left):
                u = ONE
            if v is None and _is_scalar_literal(node.right):
                v = ONE
            if u is None or v is None:
                return None
            if isinstance(op, ast.Mult):
                return _mul(u, v)
            return _div(u, v)
        if isinstance(op, ast.Mod):
            return self._unify(node, u, v)
        return None

    def _call(self, node: ast.Call) -> Optional[Unit]:  # noqa: C901
        for kw in node.keywords:
            self.unit_of(kw.value)
        name = _final_name(node.func)
        args = node.args

        if name == "unit" and len(args) == 2:
            # annotations.unit("ns", expr): the declaration wins; a known
            # contradicting inner unit is a mismatch
            inner = self.unit_of(args[1])
            if isinstance(args[0], ast.Constant) and isinstance(args[0].value, str):
                declared = _parse_unit_string(args[0].value)
                if declared is not None:
                    if inner is not None and inner != declared:
                        self._find(
                            node,
                            "unit-mismatch",
                            f"unit({args[0].value!r}, ...) wraps a "
                            f"{_fmt(inner)} expression",
                        )
                    return declared
            return inner

        arg_units = [self.unit_of(a) for a in args]

        if name in _HELPERS:
            expect, out = _HELPERS[name]
            if (
                args
                and expect is not None
                and arg_units[0] is not None
                and arg_units[0] != expect
            ):
                self._find(
                    node,
                    "unit-mismatch",
                    f"{name}() expects a {_fmt(expect)} input, got "
                    f"{_fmt(arg_units[0])}",
                )
            return out
        if name in _SELECT_FUNCS and len(args) == 3:
            return self._unify(node, arg_units[1], arg_units[2])
        if name in _PASS_THROUGH_FUNCS and args:
            known = [x for x in arg_units if x is not None]
            if name in ("max", "min", "maximum", "minimum") and len(known) > 1:
                first = known[0]
                for other in known[1:]:
                    if other != first:
                        self._find(
                            node,
                            "unit-mismatch",
                            f"{name}() over mixed units "
                            f"{_fmt(first)} and {_fmt(other)}",
                        )
                        return None
            return arg_units[0] if arg_units else None
        if (
            name in _PASS_THROUGH_METHODS
            and isinstance(node.func, ast.Attribute)
            and not args
        ):
            return self.unit_of(node.func.value)
        if name is not None and name in self.summaries:
            return self.summaries[name]
        return None

    # -- statements ------------------------------------------------------- #

    def run(self) -> None:
        self._block(self.fn.body)

    def _block(self, stmts: Sequence[ast.stmt]) -> None:  # noqa: C901
        for st in stmts:
            if isinstance(st, ast.Assign):
                u = self.unit_of(st.value)
                for tgt in st.targets:
                    self._assign(tgt, u, st)
            elif isinstance(st, ast.AnnAssign):
                if st.value is not None:
                    self._assign(st.target, self.unit_of(st.value), st)
            elif isinstance(st, ast.AugAssign):
                u = self.unit_of(st.value)
                tgt_u = self.unit_of(st.target)
                if isinstance(st.op, (ast.Add, ast.Sub)):
                    self._unify(st, tgt_u, u)
                elif isinstance(st.op, ast.Mult) and tgt_u is not None and u is not None:
                    self._assign(st.target, _mul(tgt_u, u), st, check=False)
                elif isinstance(st.op, ast.Div) and tgt_u is not None and u is not None:
                    self._assign(st.target, _div(tgt_u, u), st, check=False)
            elif isinstance(st, ast.Return):
                if st.value is not None:
                    self.return_units.append(self.unit_of(st.value))
                else:
                    self.return_units.append(None)
            elif isinstance(st, ast.Expr):
                self.unit_of(st.value)
            elif isinstance(st, (ast.If, ast.While)):
                self.unit_of(st.test)
                self._block(st.body)
                self._block(st.orelse)
            elif isinstance(st, ast.For):
                self.unit_of(st.iter)
                self._assign(st.target, None, st, check=False)
                self._block(st.body)
                self._block(st.orelse)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self.unit_of(item.context_expr)
                self._block(st.body)
            elif isinstance(st, ast.Try):
                self._block(st.body)
                for h in st.handlers:
                    self._block(h.body)
                self._block(st.orelse)
                self._block(st.finalbody)
            elif isinstance(st, ast.FunctionDef):
                sub = _FuncAnalysis(
                    self.sf, st, self.summaries, self.emit, self.checker,
                    self.exempt_conversions, outer_env=self.env,
                )
                sub.run()
                sub.check_return_suffix()
            # class defs / imports / pass / etc: nothing to do

    def _assign(
        self, tgt: ast.AST, u: Optional[Unit], st: ast.stmt, check: bool = True
    ) -> None:
        if isinstance(tgt, ast.Name):
            declared = _seed_for(tgt.id)
            if check and declared is not None and u is not None and u != declared:
                self._find(
                    st,
                    "unit-mismatch",
                    f"assigning a {_fmt(u)} value to {tgt.id!r} "
                    f"(declared {_fmt(declared)} by suffix)",
                )
            self.env[tgt.id] = declared if declared is not None else u
        elif isinstance(tgt, ast.Attribute):
            declared = _seed_for(tgt.attr)
            if check and declared is not None and u is not None and u != declared:
                self._find(
                    st,
                    "unit-mismatch",
                    f"assigning a {_fmt(u)} value to attribute "
                    f"{tgt.attr!r} (declared {_fmt(declared)} by suffix)",
                )
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._assign(e, None, st, check=False)
        elif isinstance(tgt, ast.Starred):
            self._assign(tgt.value, None, st, check=False)

    # -- function-suffix return contract ---------------------------------- #

    def check_return_suffix(self) -> Optional[Unit]:
        """Emit unit-return findings; give back the inferred return unit."""
        declared = _seed_for(self.fn.name)
        inferred: Optional[Unit] = None
        consistent = True
        for u in self.return_units:
            if u is None:
                consistent = False
                continue
            if declared is not None and u != declared:
                self._find(
                    self.fn,
                    "unit-return",
                    f"{self.fn.name}() is declared {_fmt(declared)} by "
                    f"suffix but returns a {_fmt(u)} value",
                )
            if inferred is None:
                inferred = u
            elif inferred != u:
                consistent = False
        if declared is not None:
            return declared
        return inferred if consistent else None


def _parse_unit_string(s: str) -> Optional[Unit]:
    s = s.strip()
    if "/" in s:
        num, _, den = s.partition("/")
        a = _parse_unit_string(num)
        b = _parse_unit_string(den)
        if a is None or b is None:
            return None
        return _div(a, b)
    return _UNIT_TOKENS.get(s)


# --------------------------------------------------------------------------- #
# the checker


def _functions(tree: ast.Module) -> Iterable[ast.FunctionDef]:
    """Module-level functions and methods (not nested functions — those are
    analyzed inline by their enclosing function's walk)."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            yield node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    yield sub


def _is_exempt(sf: SourceFile) -> bool:
    return sf.rel.replace("\\", "/").endswith("repro_torch/core/units.py")


@register
class UnitsChecker(Checker):
    """Physical-unit abstract interpretation (see module docstring)."""

    name = "units"
    rules = ("unit-mismatch", "unit-return", "unit-raw-conversion")

    def check_repo(
        self, files: Sequence[SourceFile], root: Path, config: CheckConfig
    ) -> Iterable[Finding]:
        # pass 1 — interprocedural summaries: every function's return unit,
        # inferred silently with an empty table, merged with name suffixes;
        # name collisions with conflicting units collapse to unknown.
        summaries: Dict[str, Optional[Unit]] = {}
        for sf in files:
            for fn in _functions(sf.tree):
                fa = _FuncAnalysis(
                    sf, fn, {}, None, self.name, _is_exempt(sf)
                )
                fa.run()
                u = fa.check_return_suffix()
                if fn.name in summaries and summaries[fn.name] != u:
                    summaries[fn.name] = None
                else:
                    summaries[fn.name] = u
        summaries.update({name: out for name, (_, out) in _HELPERS.items()})

        # pass 2 — flow-sensitive walk with the summary table; findings on.
        findings: List[Finding] = []
        for sf in files:
            for fn in _functions(sf.tree):
                fa = _FuncAnalysis(
                    sf, fn, summaries, findings, self.name, _is_exempt(sf)
                )
                fa.run()
                fa.check_return_suffix()
            # module-level statements (constants, scripts)
            mod_fn = ast.FunctionDef(
                name="<module>", args=ast.arguments(
                    posonlyargs=[], args=[], kwonlyargs=[], kw_defaults=[],
                    defaults=[],
                ),
                body=[
                    st for st in sf.tree.body
                    if not isinstance(st, (ast.FunctionDef, ast.ClassDef))
                ],
                decorator_list=[],
            )
            fa = _FuncAnalysis(
                sf, mod_fn, summaries, findings, self.name, _is_exempt(sf)
            )
            fa.run()
        return findings
