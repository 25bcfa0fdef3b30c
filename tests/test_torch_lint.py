"""The repository's lint (``python -m repro.analysis --strict``) over the
port, ``src/repro_torch``: clean, with the dispatch surfaces' axis
contracts declared through the port's own zero-cost ``annotations.axes``."""

import ast
from pathlib import Path

import pytest

from repro.analysis.framework import CheckConfig, run_checks
from repro_torch import annotations

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def test_strict_lint_over_the_port_is_clean():
    rep = run_checks([PORT], root=REPO, strict=True)
    assert rep.ok, "\n".join(f.format() for f in rep.findings)
    assert rep.files_checked > 50
    assert all(s.justification for _, s in rep.suppressed)


def test_every_dispatch_surface_of_the_port_declares_its_axes():
    """Regression lock: the port's functions that the lint names dispatch
    surfaces keep their ``@axes`` (deleting one turns the axes checker off
    for that function)."""
    required = set(CheckConfig().axes_required)
    declared, surfaces = set(), set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name in required:
                where = f"{path.relative_to(REPO)}:{node.name}"
                surfaces.add(where)
                for dec in node.decorator_list:
                    if isinstance(dec, ast.Call) and getattr(dec.func, "id", None) == "axes":
                        declared.add(where)
    assert len(surfaces) >= 12
    assert declared == surfaces


def test_axes_is_zero_cost_and_checks_its_specs():
    def f(t, bits):
        return t

    assert annotations.axes("B,N", bits="B,N")(f) is f
    with pytest.raises(ValueError, match="bad axis token"):
        annotations.axes("B,N-1")
