"""Port parity: the six examples.  Each ``examples/*_torch.py`` runs its
``run(device="cpu", hw=TPU_V5E, ...)`` and is held to the same scenario in
``repro`` with ``hw=TPU_V5E`` (the port's default is ``H100_SXM``).

The reference side: ``examples/fabric_pooling.py`` and
``examples/topology_explorer.py`` only define functions when imported, so
their own functions (``make_tenant``, ``candidate``, ``bw_override``) are
imported from their paths; ``quickstart.py``, ``serve_offload.py`` and
``migration_caching.py`` run when imported, so their scenarios are rebuilt
here through ``repro``'s public API from their constants.  Cut for time:
the quickstart to 2 steps, serve_offload to 4 decodes, migration_caching
to 3 steps a cell; no topology, policy, region size or configuration is
cut.  ``train_100m_torch.run`` is held on a narrow dense config (2 layers,
d_model 64); at its published widths only its parameter count is held.

The bars, the example loader and the comparison are ``examples/_parity.py``'s,
which ``chip_smoke.py`` holds the card's runs to as well.  The losses are
held with the weights carried across by ``repro_torch.interop`` and the
tokens drawn with numpy from a seed.
"""

import ast
import dataclasses
import functools
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_cfgs
import repro.core as R
from repro.launch.steps import make_train_step as r_make_train_step
from repro.launch.train import train_loop as r_train_loop
from repro.models import Model as RModel
from repro.models import ModelConfig as RConfig
from repro.models.phases import build_regions_and_phases as r_build
from repro.optim.adamw import AdamWConfig as RAdamWConfig
from repro.optim.adamw import adamw_init as r_adamw_init
from repro_torch import core as T
from repro_torch.analysis import run_checks as t_run_checks
from repro_torch.interop import model_params_from_arrays
from repro_torch.launch import train as t_train

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.append(str(EXAMPLES))
import _parity as parity  # noqa: E402

PORTED = ("quickstart", "serve_offload", "fabric_pooling", "migration_caching",
          "topology_explorer", "train_100m")
REL = parity.REL
CONG = dict(rel=parity.CONG_REL, abs=parity.CONG_ABS)


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Drop this file's XLA executables when it ends, so the worker that
    ran it keeps no memory mappings of them."""
    yield
    jax.clear_caches()


_example = functools.lru_cache(maxsize=None)(parity.load_example)


def _port(name: str):
    return _example(f"{name}_torch")


def _check_numbers(got: dict, want: dict):
    bad, _ = parity.mismatches(got, want)
    assert not bad, bad


def _check_sim(got, want, coherency=False):
    """A ``SimReport``, ``HostClock`` or ``FabricReport`` against the
    reference's at the bars."""
    _check_numbers(parity.report_numbers("", got, coherency),
                   parity.report_numbers("", want, coherency))


def _carried(t_cfg, r_params):
    return model_params_from_arrays(t_cfg, jax.tree.map(np.asarray, r_params), device="cpu")


# --------------------------------------------------------------------------- #
# every example: imports, device, lint
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_neither_jax_nor_repro(name):
    tree = ast.parse((EXAMPLES / f"{name}_torch.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots


@pytest.mark.parametrize("name", PORTED)
def test_example_runs_on_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).run()


def test_examples_pass_the_ports_strict_lint():
    rep = t_run_checks([EXAMPLES / f"{n}_torch.py" for n in PORTED],
                       root=EXAMPLES.parent, strict=True)
    assert rep.ok, "\n".join(f.format() for f in rep.findings)
    assert rep.files_checked == len(PORTED)


# --------------------------------------------------------------------------- #
# quickstart
# --------------------------------------------------------------------------- #


def test_quickstart_matches_the_reference():
    qs, steps = _port("quickstart"), 2
    r_cfg = dataclasses.replace(r_cfgs.get_smoke("qwen3-0.6b"), dtype=jnp.float32)
    opt_cfg = RAdamWConfig(lr=1e-3, total_steps=100)
    params = RModel(r_cfg).init(jax.random.PRNGKey(0))
    model = _carried(qs.CFG, params)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, r_cfg.vocab_size, (qs.BATCH, qs.SEQ)).astype(np.int32)
    labels = rng.integers(0, r_cfg.vocab_size, (qs.BATCH, qs.SEQ)).astype(np.int32)

    opt_state = {"adam": r_adamw_init(params, opt_cfg), "ef": {}}
    regions, phases = r_build(r_cfg, "train", batch=qs.BATCH, seq=qs.SEQ)
    sim = R.CXLMemSim(R.figure1_topology(), R.ClassMapPolicy({"opt_state": "cxl_pool2"}),
                      epoch=R.EpochSchedule("layer"), hw=R.TPU_V5E, check_capacity=False)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want_losses = []
    with sim.attach(jax.jit(r_make_train_step(r_cfg, opt_cfg)), phases, regions) as prog:
        for _ in range(steps):
            params, opt_state, metrics = prog.step(params, opt_state, batch)
            want_losses.append(float(metrics["loss"]))
        want = prog.report

    got = qs.run(device="cpu", hw=T.TPU_V5E, steps=steps, params=model,
                 batch={"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(got["losses"], want_losses, rtol=parity.LOSS_RTOL)
    assert got["losses"][1] < got["losses"][0]
    assert got["report"].steps == want.steps == steps
    _check_numbers(parity.example_numbers("quickstart", got),
                   parity.example_numbers("quickstart", {"report": want}))
    assert got["report"].congestion_s > 0
    lines = qs.report_lines(got)
    assert lines[0] == R.figure1_topology().describe()
    assert lines[1].startswith("step 0: loss=") and lines[-1].startswith("per-pool latency (ns):")


# --------------------------------------------------------------------------- #
# fabric pooling
# --------------------------------------------------------------------------- #


def test_fabric_pooling_matches_the_reference():
    jx, fp = _example("fabric_pooling"), _port("fabric_pooling")
    topo = R.pooled_topology(n_hosts=2, cxl_bandwidth_gbps=16.0)
    session = R.FabricSession(
        topo,
        [jx.make_tenant("quiet-serving", kv_bytes=1 << 24, batch=64),
         jx.make_tenant("bulk-tenant", kv_bytes=1 << 28, batch=256)],
        coherency=R.CoherencyConfig(shared_classes=("kvcache",)), hw=R.TPU_V5E,
    )
    with session:
        want = session.run(fp.ROUNDS)
    got = fp.run(device="cpu", hw=T.TPU_V5E)["report"]
    assert (got.rounds, got.epochs) == (want.rounds, want.epochs) == (5, 5)
    assert got.bi_messages == want.bi_messages > 0
    # the fabric's clock, each host's and the equal counts
    _check_numbers(parity.example_numbers("fabric_pooling", {"report": got}),
                   parity.example_numbers("fabric_pooling", {"report": want}))
    assert [h.name for h in got.hosts] == [h.name for h in want.hosts]
    assert [h.steps for h in got.hosts] == [h.steps for h in want.hosts] == [5, 5]
    assert got.congestion_s > 0 and got.coherency_s > 0


# --------------------------------------------------------------------------- #
# migration x caching
# --------------------------------------------------------------------------- #

# examples/migration_caching.py's constants, in the reference's types
R_MIGRATIONS = {
    "static": None,
    "sw-migrate": R.MigrationConfig(
        mode="software", promote_threshold=8, demote_threshold=2,
        local_budget_bytes=96 << 20, granularity_bytes=1 << 20,
    ),
    "sw+demote_pool": R.MigrationConfig(
        mode="software", promote_threshold=8, demote_threshold=2,
        local_budget_bytes=96 << 20, granularity_bytes=1 << 20,
        demote_pool="cxl_pool2",
    ),
}
R_CACHES = {"no cache": 0, "256 MiB": 256 << 20, "1 GiB": 1 << 30}
PAGE = 4096


def _r_workload():
    """examples/migration_caching.py's ``build_workload``, in ``repro``."""
    rm = R.RegionMap()
    rm.alloc("w", 64 << 20, "param")
    rm.alloc("opt", 128 << 20, "opt_state")
    rm.alloc("kv_hot", 256 * PAGE, "kvcache")
    rm.alloc("kv_cold", 64 << 20, "kvcache")
    phases = [R.Phase("decode", flops=2e9, accesses=(
        R.Access("w", 16 << 20), R.Access("kv_hot", 64 << 20, True), R.Access("kv_cold", 1 << 20),
    ))]
    return rm, phases


def _regions(rm):
    return [(r.name, r.nbytes, r.tensor_class) for r in rm.regions]


def test_migration_caching_scenario_is_the_references():
    mc = _port("migration_caching")
    assert list(mc.MIGRATIONS) == list(R_MIGRATIONS) and mc.CACHES == R_CACHES
    for name, cfg in R_MIGRATIONS.items():
        got = mc.MIGRATIONS[name]
        assert (got is None) == (cfg is None), name
        if cfg is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(cfg), name
    (rm, phases), (t_rm, t_phases) = _r_workload(), mc.build_workload()
    assert _regions(t_rm) == _regions(rm)
    assert [(p.name, p.flops, [(a.region, a.bytes_, a.is_write) for a in p.accesses])
            for p in t_phases] == [
        (p.name, p.flops, [(a.region, a.bytes_, a.is_write) for a in p.accesses])
        for p in phases]


def test_migration_caching_grid_matches_the_reference():
    mc, steps = _port("migration_caching"), 3
    step = jax.jit(lambda x: (x @ x.T).sum())
    x = jnp.ones((128, 128))
    topo = R.figure1_topology()
    got = mc.run(device="cpu", hw=T.TPU_V5E, steps=steps)
    promotions = []
    for mig_name, mig_cfg in R_MIGRATIONS.items():
        for cap_name, cap in R_CACHES.items():
            rm, phases = _r_workload()
            migration = (R.MigrationSimulator(mig_cfg, rm, topo.flatten())
                         if mig_cfg is not None else None)
            sim = R.CXLMemSim(
                topo, R.ClassMapPolicy({"kvcache": "cxl_pool1"}), hw=R.TPU_V5E,
                migration=migration,
                cache=R.DeviceCacheConfig(capacity_bytes=cap, line_bytes=PAGE) if cap else None,
            )
            with sim.attach(step, phases, rm) as prog:
                want = prog.run(steps, x)
            rep, prom = got[mig_name][cap_name]
            assert rep.steps == want.steps == steps and rep.epochs == want.epochs
            _check_sim(rep, want)
            hit, want_hit = rep.cache_hit_fraction, want.cache_hit_fraction
            assert hit == want_hit or (math.isnan(hit) and math.isnan(want_hit)), (mig_name, cap)
            assert math.isnan(hit) == (cap == 0)
            assert prom == (migration.promotions if migration is not None else None)
            promotions.append(prom)
    # the grid's reading: only demote_pool promotes
    assert promotions == [None] * 3 + [0] * 3 + [1] * 3
    assert len(mc.report_lines(got)) == 6


# --------------------------------------------------------------------------- #
# serving with KV-cache offload
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def serve_pair():
    """(the port's run, the reference's reports and first logits) on the
    same weights and prompt, 4 decodes a policy."""
    so, decodes = _port("serve_offload"), 4
    r_cfg = dataclasses.replace(r_cfgs.get_smoke("mistral-large-123b"), dtype=jnp.float32,
                                cache_dtype=jnp.float32)
    model = RModel(r_cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(1).integers(
        0, r_cfg.vocab_size, (so.B, so.PROMPT)).astype(np.int32)
    got = so.run(device="cpu", hw=T.TPU_V5E, decodes=decodes, params=_carried(so.CFG, params),
                 prompt=torch.from_numpy(prompt))

    logits, caches, clen = jax.jit(lambda p, t: model.prefill(p, t, pad_to=so.SMAX))(
        params, jnp.asarray(prompt))
    tok = jnp.argmax(logits, -1)[:, None]
    decode = jax.jit(model.decode_step)
    topo = R.two_tier_topology(cxl_latency_ns=170.0, cxl_bandwidth_gbps=32.0)
    reports, first = {}, {}
    for name, policy in {
        "local": R.LocalOnlyPolicy(),
        "kv_offload_cacheline": R.ClassMapPolicy({"kvcache": "cxl_pool"}, R.CACHELINE_BYTES),
        "kv_offload_page": R.ClassMapPolicy({"kvcache": "cxl_pool"}, R.PAGE_BYTES),
    }.items():
        regions, phases = r_build(r_cfg, "decode", batch=so.B, seq=1, cache_len=so.SMAX)
        sim = R.CXLMemSim(topo, policy, hw=R.TPU_V5E, check_capacity=False)
        with sim.attach(lambda c, t, n: decode(params, c, t, n), phases, regions) as prog:
            c, t, n = caches, tok, clen
            for i in range(decodes):
                lg, c = prog.step(c, t, n)
                if i == 0:
                    first[name] = np.asarray(lg)
                t = jnp.argmax(lg, -1)[:, None]
                n = n + 1
            reports[name] = prog.report
    return got, reports, first


def test_serve_offload_matches_the_reference(serve_pair):
    got, want, want_first = serve_pair
    assert list(got["reports"]) == list(want)
    _check_numbers(parity.example_numbers("serve_offload", got),
                   parity.example_numbers("serve_offload", {"reports": want}))
    for name, rep in got["reports"].items():
        assert rep.steps == want[name].steps == 4
        w = want_first[name]
        np.testing.assert_allclose(got["first_logits"][name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))
    assert got["reports"]["local"].latency_s == 0
    assert got["reports"]["kv_offload_cacheline"].latency_s > 0


def test_serve_offload_policies_start_from_equal_caches(serve_pair):
    first = serve_pair[0]["first_logits"]
    assert torch.equal(first["local"], first["kv_offload_cacheline"])
    assert torch.equal(first["local"], first["kv_offload_page"])


# --------------------------------------------------------------------------- #
# topology explorer
# --------------------------------------------------------------------------- #


def _reference_explorer(jx):
    """examples/topology_explorer.py's ``main`` at ``hw=TPU_V5E``, with its
    own ``candidate`` and ``bw_override``; returns what it prints."""
    cfg = dataclasses.replace(r_cfgs.get_smoke("chatglm3-6b"), dtype=jnp.float32)
    regions, phases = r_build(cfg, "train", batch=8, seq=256)
    rows, best, best_ctx = [], None, None
    for n_pools in (1, 2, 4):
        for depth in (1, 2):
            topo = jx.candidate(n_pools, depth, 32.0)
            suite = R.ScenarioSuite(topo, regions, phases, hw=R.TPU_V5E)
            pol = R.ClassMapPolicy({"opt_state": "cxl0", "grad": "cxl0" if n_pools == 1 else "cxl1"})
            res = suite.run([R.Scenario(policy=pol, topology=jx.bw_override(topo, bw),
                                        name=f"{bw:g}GBps") for bw in (16.0, 32.0, 64.0)])
            for s, bd, slow in zip(res.scenarios, res.breakdowns, res.slowdowns()):
                bw = float(s.topology.switches["sw0"]["bandwidth_gbps"])
                rows.append((n_pools, depth, bw, res.native_ns, bd.total_ns, float(slow)))
                if best is None or slow < best[0]:
                    best = (float(slow), n_pools, depth, bw)
                    best_ctx = (suite, pol)
    b = best[3]
    suite, pol = best_ctx

    def mk(bw):
        return R.Scenario(policy=pol, topology=jx.bw_override(suite.topology, bw),
                          name=f"{bw:.4g}GBps")

    def refine(sc, rnd):
        bw = float(sc.topology.switches["sw0"]["bandwidth_gbps"])
        step = 1.0 + 0.25 / (rnd + 1)
        return [mk(bw * step), mk(bw / step)]

    res, idx = suite.successive_halving([mk(b / 1.5), mk(b), mk(b * 1.5)], refine, rounds=2)
    return rows, best, (res.scenarios[idx].label(), float(res.slowdowns()[idx])), \
        suite.dispatch_count


def test_topology_explorer_matches_the_reference():
    jx, te = _example("topology_explorer"), _port("topology_explorer")
    for args in ((1, 1, 16.0), (2, 2, 64.0), (4, 2, 32.0)):
        topo = jx.candidate(*args)
        assert te.candidate(*args).describe() == topo.describe()
        assert dataclasses.asdict(te.bw_override(te.candidate(*args), 24.0)) == \
            dataclasses.asdict(jx.bw_override(topo, 24.0))
    rows, best, refined, dispatches = _reference_explorer(jx)
    got = te.run(device="cpu", hw=T.TPU_V5E)
    got_rows = [
        (n, d, float(s.topology.switches["sw0"]["bandwidth_gbps"]), res.native_ns, bd.total_ns,
         float(slow))
        for n, d, res in got["grid"]
        for s, bd, slow in zip(res.scenarios, res.breakdowns, res.slowdowns())
    ]
    assert len(got_rows) == len(rows) == 18
    for g, w in zip(got_rows, rows):
        assert g[:3] == w[:3]
        assert g[3:] == pytest.approx(w[3:], rel=REL), g[:3]
    assert got["best"][1:] == best[1:] and got["best"][0] == pytest.approx(best[0], rel=REL)
    res, idx = got["refined"]
    assert res.scenarios[idx].label() == refined[0]
    assert float(res.slowdowns()[idx]) == pytest.approx(refined[1], rel=REL)
    assert got["dispatch_count"] == dispatches == 4  # the grid, then 1 + 2 rounds
    lines = te.report_lines(got)
    assert len(lines) == 1 + 18 + 2 and lines[-1].endswith(f"({dispatches} stacked dispatches total)")


# --------------------------------------------------------------------------- #
# train 100m
# --------------------------------------------------------------------------- #

# examples/train_100m.py's configuration, in the reference
R_100M = RConfig(
    name="dense-100m", family="dense", n_layers=12, d_model=640, n_heads=10, n_kv_heads=2,
    d_head=64, d_ff=2560, vocab_size=32768, rope_variant="rope", dtype=jnp.float32,
    cache_dtype=jnp.float32, remat=False,
)
NARROW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
              vocab_size=256)


def test_train_100m_config_is_the_references():
    cfg = _port("train_100m").CONFIG
    assert cfg.param_counts()["total"] == R_100M.param_counts()["total"]
    assert 90e6 < cfg.param_counts()["total"] < 110e6
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab_size",
              "rope_variant", "remat", "family"):
        assert getattr(cfg, f) == getattr(R_100M, f), f


def test_train_100m_matches_the_reference_on_a_narrow_config(tmp_path, monkeypatch):
    tr, steps = _port("train_100m"), 6
    r_cfg = dataclasses.replace(R_100M, **NARROW)
    t_cfg = dataclasses.replace(tr.CONFIG, **NARROW)
    want = r_train_loop(r_cfg, steps=steps, batch=2, seq=16, lr=3e-4,
                        ckpt_dir=str(tmp_path / "repro"), ckpt_interval=50, simulate=True,
                        log_every=0)
    # the reference's initial weights and hardware model inside the port's loop
    params = RModel(r_cfg).init(jax.random.PRNGKey(0))
    monkeypatch.setattr(t_train, "Model", lambda cfg, device, seed: _carried(cfg, params))
    monkeypatch.setattr(t_train, "CXLMemSim", functools.partial(T.CXLMemSim, hw=T.TPU_V5E))
    got = tr.run(device="cpu", cfg=t_cfg, steps=steps, batch=2, seq=16,
                 ckpt_dir=str(tmp_path / "port"), log_every=0)
    assert got["params"] == r_cfg.param_counts()["total"]
    assert (got["steps"], got["start_step"]) == (want["steps"], want["start_step"]) == (steps, 0)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=parity.LOSS_RTOL)
    g, w = got["sim"], want["sim"]
    assert set(g) == set(w) and g["epochs"] == w["epochs"] == steps
    for k in ("latency_s", "bandwidth_s"):
        assert g[k] == pytest.approx(w[k], rel=REL), k
    assert g["congestion_s"] == pytest.approx(w["congestion_s"], **CONG)
    lines = tr.report_lines(got)
    assert lines[1].startswith("loss moved ") and lines[2].startswith("CXLMemSim:")
