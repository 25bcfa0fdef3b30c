"""The repository's lint (``python -m repro.analysis --strict``) over the
port, ``src/repro_torch``: clean, with the dispatch surfaces' axis
contracts declared through the port's own ``annotations.axes``, whose
wrapper is transparent and bitwise neutral when unarmed (the port's own
lint, ``repro_torch.analysis``, is held by ``tests/test_torch_simlint.py``)."""

import ast
from pathlib import Path

import inspect

import numpy as np
import pytest
import torch

from repro.analysis.framework import run_checks
from repro_torch import annotations
from repro_torch.analysis.framework import CheckConfig
from repro_torch.analysis.sanitize import AxisSanitizer

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def test_strict_lint_over_the_port_is_clean():
    rep = run_checks([PORT], root=REPO, strict=True)
    assert rep.ok, "\n".join(f.format() for f in rep.findings)
    assert rep.files_checked > 50
    assert all(s.justification for _, s in rep.suppressed)


def test_every_dispatch_surface_of_the_port_declares_its_axes():
    """Regression lock: the port's functions that the port's lint names
    dispatch surfaces (the analyzer's five among them) keep their ``@axes``
    (deleting one turns the axes checker off for that function)."""
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
    assert len(surfaces) >= 17
    assert {f'src/repro_torch/core/analyzer.py:{n}' for n in (
        '_analyze_batch', '_sweep_cascades', '_sweep_reduce', '_analyze_fleet',
        '_analyze_pipeline')} <= surfaces
    assert declared == surfaces


@pytest.mark.parametrize("case", ["transparent", "bitwise"])
def test_axes_is_zero_cost_and_checks_its_specs(case):
    """The wrapper publishes the function's signature and contract, gives
    bitwise the undecorated function's result armed or not (the
    reference's ``tests/test_simdim.py`` checks of its wrapper), and a
    malformed spec raises when it is declared."""
    if case == "transparent":
        @annotations.axes("K,B,N", stts="S")
        def f(t, stts, n_hosts=1):
            return t.sum() + stts.sum()

        assert f.__wrapped__ is not None
        assert list(inspect.signature(f).parameters) == ["t", "stts", "n_hosts"]
        assert f.__simlint_axes__["t"] == ("K", "B", "N")
    else:
        @annotations.axes("K,B,N", stts="S")
        def f(t, stts):
            return t * stts.sum() + torch.tensor(1.5)

        t = torch.from_numpy(np.random.default_rng(0).random((2, 3, 4)).astype(np.float32))
        stts = torch.arange(5, dtype=torch.float32)
        with AxisSanitizer():
            armed = f(t, stts)
        off = f(t, stts)
        raw = f.__wrapped__(t, stts)
        np.testing.assert_array_equal(armed.numpy(), raw.numpy())
        np.testing.assert_array_equal(off.numpy(), raw.numpy())
    with pytest.raises(ValueError, match="bad axis token"):
        annotations.axes("B,N-1")
