"""Contract checker — report key-sets and event-column passthrough (the
port's copy of ``repro/analysis/contracts.py``).

* ``summary-contract``: the dict-literal keys of ``SimReport.summary`` /
  ``FabricReport.summary`` must equal the set literals their key-lock tests
  assert (``CheckConfig.summary_contracts``: the port's reports and
  ``tests/test_torch_engine.py``), catching a field added to the report but
  not the summary (or the other way round) before the test run, and edits
  that relax the test instead of the contract.
* ``event-columns``: a ``MemEvents(...)`` (or ``MemEvents.build(...)``)
  call whose arguments are *derived from existing trace columns* (slicing,
  gathering, arithmetic on ``<x>.t_ns``-style reads) is a trace rebuild —
  it must pass ``weight=``, ``host=`` and ``qos=`` explicitly, or the
  rebuilt trace silently resets PEBS multiplicity to 1, host to 0 and the
  QoS class to 0.  Fresh-synthesis sites (``np.full``/``np.zeros``
  arguments) are not flagged: their defaults are the correct semantics.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .framework import CheckConfig, Checker, SourceFile, register

__all__ = ["ContractChecker"]

COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")
# constructor positional order; 8 positionals == every column passed
_CTOR_ARITY = len(COLUMNS)
# the trailing default-carrying columns a derived rebuild must thread through
_N_PASSTHROUGH = 3
# column names distinctive enough to signal "this argument reads an existing
# trace" — generic names (pool/region/host) appear on non-trace objects
# (``self.host``, ``region.pool``) and would false-positive
_DERIVED_MARKERS = ("t_ns", "bytes_", "is_write", "weight")


def _dict_literal_keys(fn: ast.FunctionDef) -> Optional[Tuple[ast.Dict, Set[str]]]:
    """The first all-string-keys dict literal in ``fn`` (the summary body)."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Dict) and n.keys and all(
            isinstance(k, ast.Constant) and isinstance(k.value, str)
            for k in n.keys
        ):
            return n, {k.value for k in n.keys}  # type: ignore[union-attr]
    return None


def _test_key_set(fn: ast.FunctionDef) -> Optional[Set[str]]:
    """The key set a key-lock test asserts: the set literal assigned to
    ``base`` when present, else the largest string-set literal."""
    named: Optional[Set[str]] = None
    best: Optional[Set[str]] = None
    for n in ast.walk(fn):
        if isinstance(n, ast.Set) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in n.elts
        ):
            s = {e.value for e in n.elts}  # type: ignore[union-attr]
            if best is None or len(s) > len(best):
                best = s
        if isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "base" for t in n.targets
        ):
            if isinstance(n.value, ast.Set):
                named = {
                    e.value
                    for e in n.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                }
    return named or best


def _find_method(
    tree: ast.AST, cls_name: str, method: str
) -> Optional[ast.FunctionDef]:
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef) and cls.name == cls_name:
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef) and fn.name == method:
                    return fn
    return None


def _find_function(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == name:
            return fn
    return None


def _is_memevents_call(call: ast.Call) -> Optional[str]:
    """'ctor' for ``MemEvents(...)``, 'build' for ``MemEvents.build(...)``."""
    f = call.func
    if isinstance(f, ast.Name) and f.id == "MemEvents":
        return "ctor"
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.value.id == "MemEvents" and f.attr == "build":
            return "build"
    return None


def _reads_columns(call: ast.Call) -> bool:
    exprs = list(call.args) + [kw.value for kw in call.keywords]
    for e in exprs:
        for n in ast.walk(e):
            if isinstance(n, ast.Attribute) and n.attr in _DERIVED_MARKERS:
                return True
    return False


@register
class ContractChecker(Checker):
    name = "contracts"
    rules = ("summary-contract", "event-columns")

    # ------------------------------------------------------------------ #
    # event-columns: per file
    # ------------------------------------------------------------------ #

    def check_file(
        self, sf: SourceFile, config: CheckConfig
    ) -> Iterable[Finding]:
        findings: List[Finding] = []
        for n in ast.walk(sf.tree):
            if not isinstance(n, ast.Call):
                continue
            kind = _is_memevents_call(n)
            if kind is None or not _reads_columns(n):
                continue
            kwargs = {kw.arg for kw in n.keywords}
            missing = [
                c
                for i, c in enumerate(
                    COLUMNS[-_N_PASSTHROUGH:], start=_CTOR_ARITY - _N_PASSTHROUGH
                )
                if c not in kwargs and (kind == "build" or len(n.args) <= i)
            ]
            if kind == "build" and missing:
                findings.append(sf.finding(
                    n, "event-columns",
                    "MemEvents.build() on derived trace columns cannot carry "
                    f"{'/'.join(missing)}; use the MemEvents constructor and "
                    "pass them explicitly",
                    checker="contracts",
                ))
            elif missing:
                findings.append(sf.finding(
                    n, "event-columns",
                    "trace rebuild from existing columns drops "
                    f"{'/'.join(missing)} (resets to exact-weight/host-0); "
                    "thread the source trace's columns through",
                    checker="contracts",
                ))
        return findings

    # ------------------------------------------------------------------ #
    # summary-contract: repo level
    # ------------------------------------------------------------------ #

    def check_repo(
        self, files: Sequence[SourceFile], root: Path, config: CheckConfig
    ) -> Iterable[Finding]:
        findings: List[Finding] = []
        for impl_rel, cls_name, test_rel, test_fn in config.summary_contracts:
            impl_path = root / impl_rel
            test_path = root / test_rel
            if not impl_path.exists() or not test_path.exists():
                continue  # partial checkouts (fixture runs) skip the pair
            impl_tree = ast.parse(impl_path.read_text())
            method = _find_method(impl_tree, cls_name, "summary")
            test_tree = ast.parse(test_path.read_text())
            test = _find_function(test_tree, test_fn)
            if method is None or test is None:
                findings.append(Finding(
                    impl_rel, 1, 1, "summary-contract",
                    f"cannot locate {cls_name}.summary or {test_fn} — the "
                    "key-lock contract pair is broken",
                    "contracts",
                ))
                continue
            got = _dict_literal_keys(method)
            want = _test_key_set(test)
            if got is None or want is None:
                findings.append(Finding(
                    impl_rel, method.lineno, 1, "summary-contract",
                    f"{cls_name}.summary must build a dict literal and "
                    f"{test_fn} must assert a set literal (found neither)",
                    "contracts",
                ))
                continue
            node, keys = got
            extra = keys - want
            lacking = want - keys
            if extra or lacking:
                parts = []
                if extra:
                    parts.append(
                        f"summary has keys the test does not lock: "
                        f"{sorted(extra)}"
                    )
                if lacking:
                    parts.append(
                        f"test locks keys summary does not emit: "
                        f"{sorted(lacking)}"
                    )
                findings.append(Finding(
                    impl_rel, node.lineno, node.col_offset + 1,
                    "summary-contract",
                    f"{cls_name}.summary() vs {test_fn}: " + "; ".join(parts),
                    "contracts",
                ))
        return findings
