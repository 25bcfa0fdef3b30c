"""The port stands alone: no file of ``src/repro_torch`` (nor the chip
scripts) imports JAX or the JAX package, CPU tensors take the plain path
without touching the kernel, entry points default to the card and raise
without one, and the chip smoke script refuses to report without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import mamba2_2_7b as t_m2cfg
from repro_torch.configs import qwen3_0_6b as t_q3cfg
from repro_torch.kernels import congestion as t_kernel
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ssd_scan as t_ssd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
OK_LINE = '"ok": true'


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "chip_scan_variants.py"]


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


# the model zoo's modules, migration, the device cache, the sweep and the
# fleet, checked by name so a move cannot drop them
ZOO_FILES = (
    "configs/mamba2_2_7b.py", "configs/qwen3_0_6b.py", "interop.py", "kernels/build.py",
    "kernels/flash_attention.py", "kernels/ssd_scan.py", "launch/steps.py",
    "models/attention.py", "models/config.py", "models/layers.py", "models/mamba2.py",
    "models/model.py", "models/moe.py", "models/phases.py", "models/transformer.py",
    "core/cache.py", "core/migration.py", "core/aot.py", "core/scenario.py",
    "core/fleet.py", "core/roofline.py", "configs/__init__.py",
    "configs/mistral_large_123b.py", "configs/chatglm3_6b.py", "configs/starcoder2_3b.py",
    "configs/granite_moe_3b_a800m.py", "configs/llama4_maverick_400b_a17b.py",
    "configs/jamba_v0_1_52b.py", "configs/qwen2_vl_72b.py", "configs/hubert_xlarge.py",
)


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) >= 15 and all(f.exists() for f in files)
    port = REPO / "src" / "repro_torch"
    assert {port / f for f in ZOO_FILES} <= set(files)
    bad = {
        str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}


def test_new_modules_load_without_the_reference():
    """The port's migration, cache, config registry, sweep and fleet import
    and run in a process where neither JAX nor the reference can be
    imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.configs as C\n"
        "from repro_torch.core import cache, fleet, migration, scenario\n"
        "assert len(C.ARCH_IDS) == 10 and len(C.cells()) == 40\n"
        "for a in C.ARCH_IDS:\n"
        "    C.get_config(a).param_counts()\n"
        "print(cache.DeviceCacheConfig(1 << 20).ways, migration.MigrationConfig().mode)\n"
        "t = fleet.model_zoo_tenant('z')\n"
        "f = fleet.FleetSim(1, hosts_per_rack=2, device='cpu')\n"
        "rep = f.simulate([fleet.synthetic_tenant('a', gib=0.5), t], policy='round_robin')\n"
        "s = scenario.ScenarioSuite(f.topology, t.regions, t.phases, device='cpu')\n"
        "from repro_torch.core import ClassMapPolicy\n"
        "res = s.run([scenario.Scenario(ClassMapPolicy({'opt_state': 'shared_pool'}))])\n"
        "print(rep.n_tenants, res.k, s.dispatch_count + f.dispatch_count)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["4", "software", "2", "1", "2"]


def test_roofline_input_specs_and_the_new_families_load_without_the_reference():
    """The roofline terms, ``input_specs`` and the vlm and audio families'
    models run in a process where neither JAX nor the reference can be
    imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "import repro_torch.configs as C\n"
        "from repro_torch.core import roofline_terms\n"
        "from repro_torch.models import Model\n"
        "print(roofline_terms(1e15, 1e9, 0.0, 5e14, 1).dominant)\n"
        "spec = C.input_specs(C.get_config('qwen2-vl-72b'), C.SHAPES['decode_32k'], 2)\n"
        "print(spec['embed'].device.type, tuple(spec['caches']['kv']['k'].shape)[:3])\n"
        "for a in ('hubert-xlarge', 'qwen2-vl-72b'):\n"
        "    m = Model(C.get_smoke(a), device='cpu')\n"
        "    x = torch.zeros(1, 4, m.cfg.d_model, dtype=m.cfg.dtype)\n"
        "    print(tuple(m(x)[0].shape))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:4] == ["compute", "meta (80, 1, 2)", "(1, 4, 64)",
                                            "(1, 4, 512)"]


# the training slice's modules, checked by name; msgpack is not on the
# card's machine, so the port keeps its own manifest reader and writer
TRAINING_FILES = (
    "optim/__init__.py", "optim/adamw.py", "optim/compression.py", "data/__init__.py",
    "data/pipeline.py", "checkpoint/__init__.py", "checkpoint/ckpt.py",
    "checkpoint/manager.py", "launch/train.py", "launch/steps.py", "interop.py",
)


def test_training_modules_import_neither_jax_nor_the_reference_nor_msgpack():
    port = REPO / "src" / "repro_torch"
    files = [port / f for f in TRAINING_FILES] + [REPO / "chip_smoke.py"]
    assert set(files) <= set(_port_files())
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & {*FORBIDDEN, "msgpack"})
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
    code = (
        "import sys, tempfile\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.configs.qwen3_0_6b import SMOKE\n"
        "from repro_torch.launch.train import train_loop\n"
        "d = tempfile.mkdtemp()\n"
        "out = train_loop(SMOKE, steps=3, batch=2, seq=8, ckpt_dir=d, ckpt_interval=1,\n"
        "                 log_every=0, device='cpu')\n"
        "again = train_loop(SMOKE, steps=4, batch=2, seq=8, ckpt_dir=d, ckpt_interval=1,\n"
        "                   log_every=0, device='cpu')\n"
        "print(len(out['losses']), again['start_step'])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["3", "3"]


# the port's simlint, checked by name: its checkers, sanitizers and plugin
# import neither JAX nor the reference (the annotations they read stay in
# annotations.py, which the core modules import)
ANALYSIS_FILES = (
    "analysis/__init__.py", "analysis/__main__.py", "analysis/findings.py",
    "analysis/framework.py", "analysis/locks.py", "analysis/contracts.py",
    "analysis/units.py", "analysis/axes.py", "analysis/dispatch.py",
    "analysis/sanitize.py", "analysis/pytest_plugin.py", "annotations.py",
)


def test_analysis_imports_neither_jax_nor_the_reference():
    port = REPO / "src" / "repro_torch"
    files = [port / f for f in ANALYSIS_FILES]
    assert set(files) <= set(_port_files())
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
    code = (
        "import sys, threading\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from pathlib import Path\n"
        "from repro_torch.analysis import run_checks\n"
        "from repro_torch.analysis.sanitize import (AxisSanitizer, LockOrderSanitizer,\n"
        "                                           RecompileSanitizer)\n"
        "import repro_torch.analysis.pytest_plugin\n"
        f"rep = run_checks([Path({str(port)!r})], root=Path({str(REPO)!r}), strict=True)\n"
        "with LockOrderSanitizer() as lo, RecompileSanitizer() as rc, AxisSanitizer() as ax:\n"
        "    with threading.Lock():\n"
        "        pass\n"
        "print(rep.ok, rep.files_checked > 50, lo.locks_created, rc.aot_lowerings, ax.checks)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ok, files, locks, lowerings, checks = proc.stdout.split()
    # the scope also tracks module-level locks of what it first imports
    assert (ok, files, lowerings, checks) == ("True", "True", "0", "0") and int(locks) >= 1


def test_cpu_tensors_take_the_plain_path():
    t = torch.sort(torch.rand(2, 64) * 100.0).values
    bits = torch.randint(0, 4, (2, 64), dtype=torch.int32)
    stts = torch.tensor([2.0, 1.0])
    plain0, kernel0 = t_ops.plain_launches, t_kernel.launches
    tf, idx, psd = t_ops.congestion_cascade(t, bits, stts)
    assert t_ops.plain_launches == plain0 + 1
    assert t_kernel.launches == kernel0
    assert tf.shape == t.shape and psd.shape == (2, 2)


def test_cpu_tensors_take_the_plain_ssd_path():
    x = torch.randn(1, 32, 2, 4)
    dt = torch.full((1, 32, 2), 0.1)
    bm = torch.randn(1, 32, 8)
    plain0, kernel0 = t_ops.plain_launches, t_ssd.ssd_launches
    y = t_ops.ssd(x, dt, -torch.ones(2), bm, bm, chunk=16)
    assert t_ops.plain_launches == plain0 + 1
    assert t_ssd.ssd_launches == kernel0
    assert y.shape == x.shape and y.dtype == x.dtype


def test_cpu_tensors_take_the_plain_attention_path():
    q = torch.randn(1, 4, 8, 32)
    kv = torch.randn(1, 2, 8, 32)
    plain0, kernel0 = t_ops.plain_launches, t_flash.flash_launches
    o = t_ops.attention(q, kv, kv, q_offset=0, causal=True)
    assert t_ops.plain_launches == plain0 + 1
    assert t_flash.flash_launches == kernel0
    assert o.shape == q.shape and o.dtype == q.dtype


def test_model_entry_points_default_to_the_card():
    import inspect

    from repro_torch.interop import model_params_from_arrays
    from repro_torch.models import Model
    from repro_torch.models.mamba2 import init_mamba2_cache

    for fn in (Model.__init__, model_params_from_arrays, init_mamba2_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(t_m2cfg.SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(t_q3cfg.SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_params_from_arrays(t_m2cfg.SMOKE, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mamba2_cache(1, 2, 4, 8)


def test_sweep_and_fleet_default_to_the_card():
    import inspect

    from repro_torch.core import FleetSim, RegionMap, ScenarioSuite, figure1_topology

    for fn in (ScenarioSuite.__init__, FleetSim.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScenarioSuite(figure1_topology(), RegionMap(), [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetSim(2)


def test_kernel_wrapper_refuses_cpu_tensors():
    t = torch.zeros(1, 8)
    i32 = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.congestion_cascade(t, i32, torch.ones(1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.congestion_cascade_hosts(t, i32, i32, torch.ones(1), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.congestion_scan(t, torch.zeros(1, 8, dtype=torch.bool), 1.0)
    x = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ssd.ssd_scan(x, torch.zeros(1, 8, 1), torch.ones(1), torch.zeros(1, 8, 2),
                       torch.zeros(1, 8, 2))
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_flash.flash_attention(q, q, q)
    assert not t_kernel._libs  # nothing was built or loaded


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
