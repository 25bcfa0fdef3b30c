"""The port stands alone: no file of ``src/repro_torch`` (nor the chip smoke
script) imports JAX or the JAX package, CPU tensors take the plain path
without touching the kernel, and the chip smoke script refuses to report
without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import congestion as t_kernel
from repro_torch.kernels import ops as t_ops

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
OK_LINE = '"ok": true'


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) >= 15 and all(f.exists() for f in files)
    bad = {
        str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}


def test_cpu_tensors_take_the_plain_path():
    t = torch.sort(torch.rand(2, 64) * 100.0).values
    bits = torch.randint(0, 4, (2, 64), dtype=torch.int32)
    stts = torch.tensor([2.0, 1.0])
    plain0, kernel0 = t_ops.plain_launches, t_kernel.launches
    tf, idx, psd = t_ops.congestion_cascade(t, bits, stts)
    assert t_ops.plain_launches == plain0 + 1
    assert t_kernel.launches == kernel0
    assert tf.shape == t.shape and psd.shape == (2, 2)


def test_kernel_wrapper_refuses_cpu_tensors():
    t = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.congestion_cascade(t, torch.zeros(1, 8, dtype=torch.int32), torch.ones(1))
    assert t_kernel._lib is None  # nothing was built or loaded


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        cwd = tmp_path
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout
