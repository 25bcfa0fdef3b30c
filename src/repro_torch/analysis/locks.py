"""Lock-discipline checker (the port's copy of ``repro/analysis/locks.py``).

Classes declare guarded attributes with
:func:`repro_torch.annotations.guarded_by`::

    class AttachedProgram(EngineClient):
        _simlint_guards = guarded_by("_report_lock", "_report")

The checker then verifies every lexical read/write of a guarded attribute
inside the class's methods happens under a ``with <...>.<lock>:`` block
whose context expression ends in the declared lock name.  Exempt:
``__init__``/``__post_init__``, methods named ``*_locked`` (the
caller-holds-it convention), and methods decorated
``@single_threaded("why")``.

This is *lexical* checking: a closure defined inside a ``with`` block runs
later, without the lock, so nested functions are checked against an empty
held-lock set — which is exactly the bug class where a fold callback built
under the lock escapes to the dispatcher thread.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from .findings import Finding
from .framework import CheckConfig, Checker, SourceFile, register

__all__ = ["LockDisciplineChecker"]

RULE = "lock-discipline"
GUARDS_ATTR = "_simlint_guards"
EXEMPT_NAMES = ("__init__", "__post_init__")


def _call_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            return f.id
        if isinstance(f, ast.Attribute):
            return f.attr
    return None


def _parse_guards(value: ast.AST) -> Optional[Dict[str, Tuple[str, ...]]]:
    """Parse ``guarded_by(...)`` / ``guarded_by(...) | guarded_by(...)``."""
    if isinstance(value, ast.BinOp) and isinstance(value.op, ast.BitOr):
        left = _parse_guards(value.left)
        right = _parse_guards(value.right)
        if left is None or right is None:
            return None
        for lock, fields in right.items():
            left[lock] = tuple(dict.fromkeys(left.get(lock, ()) + fields))
        return left
    if _call_name(value) == "guarded_by":
        args = value.args  # type: ignore[union-attr]
        if args and all(
            isinstance(a, ast.Constant) and isinstance(a.value, str) for a in args
        ):
            return {args[0].value: tuple(a.value for a in args[1:])}
    return None


def _class_guards(cls: ast.ClassDef) -> Optional[Dict[str, Tuple[str, ...]]]:
    for stmt in cls.body:
        if (
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == GUARDS_ATTR for t in stmt.targets
            )
        ):
            return _parse_guards(stmt.value)
    return None


def _is_exempt(fn: ast.AST) -> bool:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return True
    if fn.name in EXEMPT_NAMES or fn.name.endswith("_locked"):
        return True
    for dec in fn.decorator_list:
        if _call_name(dec) == "single_threaded":
            return True
    return False


def _with_lock_names(node: ast.With) -> List[str]:
    names = []
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Attribute):
            names.append(expr.attr)
        elif isinstance(expr, ast.Name):
            names.append(expr.id)
    return names


class _MethodVisitor(ast.NodeVisitor):
    """Walk one method body tracking the lexically-held lock set."""

    def __init__(
        self,
        sf: SourceFile,
        guards: Dict[str, Tuple[str, ...]],
        method: str,
    ):
        self.sf = sf
        self.method = method
        self.held: List[str] = []
        self.findings: List[Finding] = []
        # field spec -> lock, split into plain and dotted ("owner.field")
        self.plain: Dict[str, str] = {}
        self.dotted: Dict[Tuple[str, str], str] = {}
        for lock, fields in guards.items():
            for f in fields:
                if "." in f:
                    owner, attr = f.rsplit(".", 1)
                    self.dotted[(owner, attr)] = lock
                else:
                    self.plain[f] = lock

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self.visit(item.context_expr)
        locks = _with_lock_names(node)
        self.held.extend(locks)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - len(locks):]

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def _enter_scope(self, node: ast.AST) -> None:
        # nested defs/lambdas run later, when the enclosing with-block's
        # lock is no longer held
        held, self.held = self.held, []
        self.generic_visit(node)
        self.held = held

    visit_FunctionDef = _enter_scope  # type: ignore[assignment]
    visit_AsyncFunctionDef = _enter_scope  # type: ignore[assignment]
    visit_Lambda = _enter_scope  # type: ignore[assignment]

    def visit_Attribute(self, node: ast.Attribute) -> None:
        lock = self.plain.get(node.attr)
        if lock is None and isinstance(node.value, ast.Attribute):
            lock = self.dotted.get((node.value.attr, node.attr))
        if lock is not None and lock not in self.held:
            self.findings.append(
                self.sf.finding(
                    node,
                    RULE,
                    f"'{node.attr}' is guarded by '{lock}' but accessed in "
                    f"'{self.method}' outside 'with ...{lock}:'",
                    checker="locks",
                )
            )
        self.generic_visit(node)


@register
class LockDisciplineChecker(Checker):
    name = "locks"
    rules = (RULE,)

    def check_file(
        self, sf: SourceFile, config: CheckConfig
    ) -> Iterable[Finding]:
        findings: List[Finding] = []
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            guards = _class_guards(cls)
            if not guards:
                continue
            for fn in cls.body:
                if _is_exempt(fn):
                    continue
                visitor = _MethodVisitor(sf, guards, f"{cls.name}.{fn.name}")
                for stmt in fn.body:  # type: ignore[union-attr]
                    visitor.visit(stmt)
                findings.extend(visitor.findings)
        return findings
