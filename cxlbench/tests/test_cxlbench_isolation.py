"""Nothing the benchmark runs on the card loads JAX or the JAX package,
the references load nothing of the port, and the benchmark reads nothing
of the JAX package's benchmarks.  Module names are compared by their whole
top-level name (the part before the first dot): ``repro_torch`` is not
``repro``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "cxlbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded_after(imports: str) -> set:
    """Top-level names in ``sys.modules`` of a fresh process after ``imports``."""
    code = (f"import sys, json\n{imports}\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_and_its_drivers_load_no_jax():
    names = _loaded_after("import cxlbench.run, cxlbench.control, cxlbench.profiling\n"
                          "from cxlbench.drivers import attached_prefill, fabric_rounds, "
                          "scenario_sweep")
    assert "repro_torch" in names
    assert not names & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    names = _loaded_after("import cxlbench.reference.model, cxlbench.reference.pricing, "
                          "cxlbench.reference.program, cxlbench.roofline, cxlbench.inputs")
    assert not names & (FORBIDDEN | {"repro_torch"})


def _sources():
    return sorted(p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax_or_reads_benchmarks(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not {a.name.split(".")[0] for a in node.names} & FORBIDDEN
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in FORBIDDEN
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks/" not in node.value and "BENCH_" not in node.value
    if "reference" in path.relative_to(PKG).parts:
        assert "repro_torch" not in path.read_text().replace("the port", "")
