"""The port's simlint (``repro_torch.analysis``) end to end, on the CPU: the
shared checkers against the reference's on its seeded-violation corpus
(``tests/fixtures/simlint``), the dispatch rules on inline corpora written
to ``tmp_path``, suppression semantics, the port's strict gate, the CLI, and
the lock-order and recompile sanitizers (budgets on the dispatch cache and
on ``kernels/build.py``'s ``nvcc`` counter).

The sanitizer tests are marked ``no_sanitize``: they patch ``threading``
themselves and must not run nested inside a ``SIMLINT_SANITIZE=1`` harness.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as R
import repro_torch.core as T
from repro_torch import analysis as P
from repro_torch.analysis.framework import CheckConfig

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "simlint"
SHARED = ["locks", "contracts", "units", "axes"]
# the marker is concatenated so this file's own lines never register as
# suppressions in the repository-wide scans
MARK = "# simlint" ": ignore"
PORT_MARK = "# simlint-torch" ": ignore"


def _keys(rep):
    return {(f.path, f.line, f.col, f.rule) for f in rep.findings}


def _port_config(ref_config=None):
    """The port's CheckConfig carrying the reference's shared knobs."""
    ref_config = ref_config or R.CheckConfig()
    return CheckConfig(exclude=ref_config.exclude, axes_required=ref_config.axes_required,
                       summary_contracts=ref_config.summary_contracts)


def _check(*names, checkers=None, strict=False, config=None):
    return P.run_checks([FIXTURES / n for n in names], root=FIXTURES, strict=strict,
                        checker_names=checkers, config=config)


# --------------------------------------------------------------------------- #
# parity with the reference's checkers on its corpus
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fixture", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_shared_checkers_match_the_reference_on_its_corpus(fixture):
    """locks, contracts, units and axes give the reference's findings,
    location and rule, on every file of its corpus."""
    ref = R.run_checks([FIXTURES / fixture], root=FIXTURES, checker_names=SHARED)
    port = P.run_checks([FIXTURES / fixture], root=FIXTURES, checker_names=SHARED,
                        config=_port_config())
    assert _keys(port) == _keys(ref)
    if fixture.startswith("bad_") and "jit" not in fixture:
        assert port.findings, "a seeded corpus gave no finding"


@pytest.mark.parametrize("which", ["bad", "good"])
def test_summary_contract_matches_the_reference(which):
    ref_config = R.CheckConfig(summary_contracts=(
        (f"contract_impl_{which}.py", "SimReport",
         f"contract_test_{which}.py", "test_sim_report_summary_keys_locked"),
    ))
    names = [f"contract_impl_{which}.py"]
    ref = R.run_checks([FIXTURES / n for n in names], root=FIXTURES,
                       checker_names=["contracts"], config=ref_config)
    port = _check(*names, checkers=["contracts"], config=_port_config(ref_config))
    assert _keys(port) == _keys(ref)
    assert [f.message for f in port.findings] == [f.message for f in ref.findings]
    assert bool(port.findings) == (which == "bad")


def test_lock_checker_flags_report_race_and_escaping_closure():
    rep = _check("bad_report_race.py", checkers=["locks"])
    assert {f.rule for f in rep.findings} == {"lock-discipline"}
    assert len(rep.findings) == 4
    methods = {f.message.split("'")[5] for f in rep.findings}
    assert methods == {"RacyClient.fold", "RacyClient.snapshot", "RacyClient.escape"}
    assert _check("good_report_race.py", checkers=["locks"]).ok


def test_contract_checker_flags_weight_drop():
    rep = _check("bad_weight_drop.py", checkers=["contracts"])
    assert {f.rule for f in rep.findings} == {"event-columns"}
    msgs = sorted(f.message for f in rep.findings)
    assert len(msgs) == 2 and any("MemEvents.build" in m for m in msgs)
    assert any("weight/host" in m for m in msgs)
    assert _check("good_weight_drop.py", checkers=["contracts"]).ok


def test_port_summary_contracts_name_the_port_reports():
    pairs = CheckConfig().summary_contracts
    assert {(c, t, f) for _, c, t, f in pairs} == {
        ("SimReport", "tests/test_torch_engine.py", "test_sim_report_summary_keys_locked"),
        ("FabricReport", "tests/test_torch_engine.py", "test_fabric_report_summary_keys_locked"),
    }
    rep = P.run_checks([REPO / p for p, *_ in pairs], root=REPO, checker_names=["contracts"])
    assert rep.ok, [f.format() for f in rep.findings]


# --------------------------------------------------------------------------- #
# the dispatch rules, on inline corpora
# --------------------------------------------------------------------------- #

HOST_SYNC_BAD = '''
import torch


def _analyze_batch(t: torch.Tensor, valid: torch.Tensor, n: int):
    total = t.sum()
    if total > 0:                       # branch on a tensor's value
        t = t * 2
    k = int(valid.sum())                # int() of a tensor
    m = total.item()                    # .item()
    host = t.cpu()                      # .cpu()
    torch.cuda.synchronize()            # a sync
    return t, k, m, host
'''
HOST_SYNC_GOOD = '''
from typing import Optional

import torch


def _analyze_batch(t: torch.Tensor, host: Optional[torch.Tensor], n_hosts: int):
    rows = int(t.shape[0])              # metadata, not a value
    if host is None or n_hosts == 1:    # identity and host ints
        host = torch.zeros_like(t, dtype=torch.int32)
    if t.dim() == 2 and len(t) > 0:     # metadata again
        t = t + 1.0
    if any(x.data_ptr() % 16 for x in (t, host)):
        raise ValueError("misaligned")
    return torch.where(t > 0, t, 0.0).sum(dim=1), rows


def not_a_surface(t: torch.Tensor):
    return t.sum().item()               # off the dispatch path: not flagged
'''
BYPASS_BAD = '''
import ctypes
import subprocess


def load(path):
    return ctypes.CDLL(path)


def build(src):
    subprocess.run(["nvcc", "-shared", "-o", "k.so", src], check=True)
'''
BYPASS_GOOD = '''
import subprocess

from repro_torch.kernels import build


def load(bind):
    return build.load("congestion_cascade", bind)


def smi():
    return subprocess.run(["nvidia-smi"], capture_output=True)
'''
F64_BAD = '''
import torch


def congestion_cascade(t: torch.Tensor):
    acc = t.to(torch.float64)
    return acc.double().sum()
'''
F64_GOOD = '''
import torch


def congestion_cascade(t: torch.Tensor):
    return t.to(torch.float32).sum()
'''
ACCUMULATOR = '''
import torch


def _accumulator(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.device.type == "cuda" else x.dtype
'''
# rule -> (file under tmp_path, bad corpus, good corpus, findings of the bad)
DISPATCH_CORPORA = {
    "host-sync": ("core/analyzer.py", HOST_SYNC_BAD, HOST_SYNC_GOOD, 5),
    "build-bypass": ("core/loader.py", BYPASS_BAD, BYPASS_GOOD, 2),
    "f64": ("kernels/congestion.py", F64_BAD, F64_GOOD, 2),
}


def _write(tmp_path, rel, text):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


@pytest.mark.parametrize("rule", sorted(DISPATCH_CORPORA))
def test_dispatch_rule_fires_on_its_bad_corpus(rule, tmp_path):
    rel, bad, _, n = DISPATCH_CORPORA[rule]
    p = _write(tmp_path, rel, bad)
    rep = P.run_checks([p], root=tmp_path, checker_names=["dispatch"])
    assert [f.rule for f in rep.findings] == [rule] * n, [f.format() for f in rep.findings]


@pytest.mark.parametrize("rule", sorted(DISPATCH_CORPORA))
def test_dispatch_rule_quiet_on_its_good_corpus(rule, tmp_path):
    rel, _, good, _ = DISPATCH_CORPORA[rule]
    p = _write(tmp_path, rel, good)
    rep = P.run_checks([p], root=tmp_path, checker_names=["dispatch"])
    assert rep.ok, [f.format() for f in rep.findings]


def test_dispatch_rules_spare_the_build_file_the_plain_versions_and_accumulators(tmp_path):
    """kernels/build.py may load libraries and run nvcc; the plain versions
    (kernels/ref.py) run on CPU tensors; an f64 accumulator outside the
    kernel wrappers is deliberate."""
    paths = [
        _write(tmp_path, "kernels/build.py", BYPASS_BAD),
        _write(tmp_path, "kernels/ref.py", F64_BAD + HOST_SYNC_BAD),
        _write(tmp_path, "core/analyzer2.py", ACCUMULATOR),
    ]
    rep = P.run_checks(paths, root=tmp_path, checker_names=["dispatch"])
    assert rep.ok, [f.format() for f in rep.findings]


def test_port_only_marker_is_read_by_the_port_and_not_by_the_reference(tmp_path):
    """A dispatch finding suppressed with the port-only marker passes the
    port's strict gate, and the reference's strict gate (also run over the
    port) neither reads it nor calls it unused."""
    text = BYPASS_BAD.replace(
        "return ctypes.CDLL(path)",
        f"return ctypes.CDLL(path)  {PORT_MARK}[build-bypass] -- a test's own loader",
    ).replace("    subprocess.run(", f"    subprocess.run(  {PORT_MARK}[build-bypass] -- ditto\n        ")
    p = _write(tmp_path, "core/loader.py", text)
    port = P.run_checks([p], root=tmp_path, strict=True)
    assert port.ok and len(port.suppressed) == 2, [f.format() for f in port.findings]
    ref = R.run_checks([p], root=tmp_path, strict=True)
    assert ref.ok, [f.format() for f in ref.findings]


# --------------------------------------------------------------------------- #
# framework: suppressions, parse errors
# --------------------------------------------------------------------------- #

_REBUILD = (
    "from repro_torch.core.events import MemEvents\n\n\n"
    "def f(ev):\n"
    "    return MemEvents(ev.t_ns, ev.pool, ev.bytes_, ev.is_write, ev.region){}\n"
)


@pytest.mark.parametrize("case", ["justified", "bare", "unused", "parse-error"])
def test_suppression_rules_and_parse_errors(case, tmp_path):
    p = tmp_path / "snippet.py"
    if case == "justified":
        p.write_text(_REBUILD.format(f"  {MARK}[event-columns] -- fixture: defaults intended"))
        rep = P.run_checks([p], root=tmp_path, strict=True)
        assert rep.ok and len(rep.suppressed) == 1
    elif case == "bare":
        p.write_text(_REBUILD.format(f"  {MARK}[event-columns]"))
        assert P.run_checks([p], root=tmp_path).ok  # non-strict: still silences
        rep = P.run_checks([p], root=tmp_path, strict=True)
        assert [f.rule for f in rep.findings] == ["bare-suppression"]
    elif case == "unused":
        p.write_text(f"x = 1  {PORT_MARK}[host-sync] -- stale\n")
        rep = P.run_checks([p], root=tmp_path, strict=True)
        assert [f.rule for f in rep.findings] == ["unused-suppression"]
    else:
        p.write_text("def f(:\n")
        assert [f.rule for f in P.run_checks([p], root=tmp_path).findings] == ["parse-error"]


# --------------------------------------------------------------------------- #
# the port itself: strict gate, annotation locks, the CLI
# --------------------------------------------------------------------------- #


def _port_paths():
    return [REPO / "src" / "repro_torch"] + sorted((REPO / "tests").glob("test_torch_*.py"))


def test_port_strict_gate_is_clean():
    rep = P.run_checks(_port_paths(), root=REPO, strict=True)
    assert rep.ok, "\n".join(f.format() for f in rep.findings)
    assert rep.files_checked > 100
    assert all(s.justification for _, s in rep.suppressed)
    # the one host sync the port keeps on its dispatch path, justified
    syncs = [f for f, _ in rep.suppressed if f.rule == "host-sync"]
    assert {f.path for f in syncs} == {"src/repro_torch/core/analyzer.py"}
    assert set(P.registered_checkers()) == {"axes", "contracts", "dispatch", "locks", "units"}


def test_concurrency_core_keeps_its_guard_annotations():
    for rel in ("core/engine.py", "core/attach.py", "core/fabric.py"):
        assert "_simlint_guards" in (REPO / "src" / "repro_torch" / rel).read_text(), rel


@pytest.mark.parametrize("case", ["strict-json", "findings", "unknown-checker"])
def test_cli_exit_codes(case, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.analysis"]
    if case == "strict-json":
        cmd += ["--strict", "--json"]
    elif case == "findings":
        p = _write(tmp_path, "kernels/k.py", F64_BAD)
        cmd += ["--root", str(tmp_path), str(p)]
    else:
        cmd += ["--checkers", "nope"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    if case == "strict-json":
        assert out.returncode == 0, out.stdout + out.stderr
        data = json.loads(out.stdout)
        assert data["findings"] == [] and data["files_checked"] > 100
        assert all(s["justification"] for s in data["suppressed"])
    elif case == "findings":
        assert out.returncode == 1 and "[f64]" in out.stdout, out.stdout + out.stderr
    else:
        assert out.returncode == 2 and "unknown checkers" in out.stderr


# --------------------------------------------------------------------------- #
# LockOrderSanitizer
# --------------------------------------------------------------------------- #


def _inverted_order_program():
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass


@pytest.mark.no_sanitize
def test_lock_order_cycle_detected_and_record_only():
    from repro_torch.analysis.sanitize import LockOrderError, LockOrderSanitizer

    with pytest.raises(LockOrderError, match="lock-order cycle"):
        with LockOrderSanitizer():
            _inverted_order_program()
    san = LockOrderSanitizer(record_only=True)
    with san:
        _inverted_order_program()
    cycle = san.find_cycle()
    assert cycle is not None and "lock-order cycle" in san.format_cycle(cycle)


@pytest.mark.no_sanitize
def test_lock_order_clean_on_consistent_nesting():
    from repro_torch.analysis.sanitize import LockOrderSanitizer

    san = LockOrderSanitizer()
    with san:  # the same nesting twice: one edge, no cycle
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(2):
            with a:
                with b:
                    pass
    assert san.locks_created == 2 and len(san.edges) == 1
    assert san.find_cycle() is None


@pytest.mark.no_sanitize
def test_lock_order_sanitizer_restores_factories_inside_the_reference():
    """Entered inside the reference's sanitizer, the port's wraps its
    factories, finds the cycle, and each exit restores the factories it
    found.  (The outer one sees every lock made through the inner factory
    at one creation site, whose edges it skips.)"""
    from repro.analysis.sanitize import LockOrderSanitizer as RefSanitizer
    from repro_torch.analysis.sanitize import LockOrderSanitizer

    orig_lock, orig_rlock = threading.Lock, threading.RLock
    outer = RefSanitizer(record_only=True)
    with outer:
        ref_lock, ref_rlock = threading.Lock, threading.RLock
        inner = LockOrderSanitizer(record_only=True)
        with inner:
            assert threading.Lock is not ref_lock
            _inverted_order_program()
        assert threading.Lock is ref_lock and threading.RLock is ref_rlock
    assert threading.Lock is orig_lock and threading.RLock is orig_rlock
    assert inner.find_cycle() is not None


@pytest.mark.no_sanitize
def test_lock_order_cycle_parity_with_the_reference():
    """The same lock nesting gives the same cycle, by creation site, in both
    packages."""
    from repro.analysis.sanitize import LockOrderSanitizer as RefSanitizer
    from repro_torch.analysis.sanitize import LockOrderSanitizer

    cycles = []
    for cls in (RefSanitizer, LockOrderSanitizer):
        san = cls(record_only=True)
        with san:
            _inverted_order_program()
        cycles.append((san.find_cycle(), set(san.edges)))
    assert cycles[0] == cycles[1] and cycles[0][0] is not None


@pytest.mark.no_sanitize
def test_lock_order_wrapped_condition_wait_notify():
    """threading.Condition keeps working over wrapped locks across real
    threads (it relies on _is_owned/_release_save/_acquire_restore)."""
    from repro_torch.analysis.sanitize import LockOrderSanitizer

    with LockOrderSanitizer():
        for lock in (threading.Lock(), threading.RLock(), None):
            cv = threading.Condition(lock)
            done = []

            def worker():
                with cv:
                    done.append(1)
                    cv.notify()

            t = threading.Thread(target=worker)
            with cv:
                t.start()
                assert cv.wait_for(lambda: done, timeout=10)
            t.join()


@pytest.mark.no_sanitize
def test_engine_sessions_leave_an_acyclic_lock_order():
    """Two asynchronous sessions on one engine, built inside the scope:
    every engine, session and cache lock is tracked, and the order graph
    has no cycle."""
    from repro_torch.analysis.sanitize import LockOrderSanitizer

    flat = T.figure1_topology().flatten()
    traces = [T.synthetic_trace(600 + 200 * i, flat.n_pools, epoch_ns=2e5, seed=i)
              for i in range(3)]
    with LockOrderSanitizer() as san:
        with T.AnalysisEngine() as eng:
            handles = [eng.register(T.EpochAnalyzer(flat, device="cpu")) for _ in range(2)]
            futures = [h.submit(traces) for h in handles for _ in range(2)]
            for h in handles:
                h.flush()
                h.close()
    assert all(f.result().total_ns > 0 for f in futures)
    assert san.locks_created > 0 and san.find_cycle() is None


# --------------------------------------------------------------------------- #
# RecompileSanitizer
# --------------------------------------------------------------------------- #


@pytest.mark.no_sanitize
def test_recompile_sanitizer_steady_state_and_cache_miss():
    from repro_torch.analysis.sanitize import RecompileError, RecompileSanitizer

    cache = T.AotDispatchCache()
    assert cache.warm("k", lambda: np.zeros(4)) and not cache.warm("k", lambda: None)
    with RecompileSanitizer() as san:
        _, hit = cache.get("k", lambda: np.zeros(4))
        assert hit
    assert san.aot_lowerings == 0 and san.builds == 0
    with pytest.raises(RecompileError, match="dispatch-cache build"):
        with RecompileSanitizer():
            cache.get("never-warmed", lambda: np.zeros(8))


@pytest.mark.no_sanitize
def test_recompile_sanitizer_budget_and_record_only():
    from repro_torch.analysis.sanitize import RecompileSanitizer

    # both caches stay referenced: the registry is a WeakSet, so dropping
    # one mid-scope would shrink the baseline under the sanitizer's feet
    cache1 = T.AotDispatchCache()
    with RecompileSanitizer(allowed_lowerings=1):
        cache1.get("one-build-allowed", lambda: np.zeros(2))
    san = RecompileSanitizer(record_only=True)
    with san:
        cache2 = T.AotDispatchCache()
        cache2.get("recorded-miss", lambda: np.zeros(2))
    assert san.aot_lowerings == 1
    assert T.AotDispatchCache.total_lowerings() >= cache1.lowerings + cache2.lowerings


@pytest.mark.no_sanitize
@pytest.mark.parametrize("allowed", [0, None])
def test_recompile_sanitizer_counts_nvcc_runs(allowed, monkeypatch):
    """An nvcc run inside the scope (the counter bumped as build() bumps it)
    fails a zero budget and is recorded without one."""
    from repro_torch.analysis.sanitize import RecompileError, RecompileSanitizer
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "nvcc_runs", build.nvcc_runs)
    san = RecompileSanitizer(allowed_builds=allowed)
    if allowed == 0:
        with pytest.raises(RecompileError, match="nvcc run"):
            with san:
                build.nvcc_runs += 1
    else:
        with san:
            build.nvcc_runs += 1
    assert san.builds == 1


@pytest.mark.no_sanitize
def test_steady_state_pipeline_and_sweep_build_nothing():
    """A warmed pipeline analyzer and a sweep's second run build no
    dispatch-cache entry: lowerings and compile_cache_size stay flat."""
    from repro_torch.analysis.sanitize import RecompileSanitizer

    flat = T.figure1_topology().flatten()
    traces = [T.synthetic_trace(900, flat.n_pools, epoch_ns=2e5, seed=s, burstiness=0.9,
                                granule_bytes=4096) for s in range(3)]
    an = T.EpochAnalyzer(flat, n_windows=32, device="cpu", pipeline=True)
    assert an.warmup(traces)
    with RecompileSanitizer(allowed_lowerings=0, allowed_builds=0) as san:
        a = an.analyze_batch(traces)
        b = an.analyze_batch(traces)
    assert san.aot_lowerings == 0 and a.total_ns == b.total_ns > 0

    rm = T.RegionMap()
    for i, cls in enumerate(("param", "opt_state", "kvcache")):
        rm.alloc(f"r{i}", (i + 1) << 20, cls).access_count = 10.0
    phases = [T.Phase("p", 5e10, tuple(T.Access(f"r{i}", 2e6, i == 2) for i in range(3)))]
    suite = T.ScenarioSuite(T.figure1_topology(), rm, phases, hw=T.TPU_V5E, device="cpu")
    scens = [T.Scenario(T.LocalOnlyPolicy()),
             T.Scenario(T.ClassMapPolicy({"opt_state": "cxl_pool2"}))]
    first = suite.run(scens)
    size = suite.compile_cache_size()
    assert size >= 1
    with RecompileSanitizer(allowed_lowerings=0) as san:
        again = suite.run(scens)
    assert san.aot_lowerings == 0 and suite.compile_cache_size() == size
    totals = [[(b.latency_ns, b.congestion_ns, b.bandwidth_ns) for b in r.breakdowns]
              for r in (first, again)]
    assert totals[0] == totals[1]
