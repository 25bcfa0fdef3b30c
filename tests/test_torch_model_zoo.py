"""Port parity for the model zoo's configurations, structure only: the
registry (``ARCH_IDS``, ``SHAPES``, ``get_config``, ``get_smoke``,
``cells``), every arch's ``CONFIG``, ``SMOKE`` and ``LONG``, their group
structure and analytic parameter counts, and the memory programs
``build_regions_and_phases`` makes of them — ``repro_torch`` against
``repro`` on the same configs.

Bars: exact.  Counts equal the reference's ``eval_shape`` counts to the
last parameter (``active`` in the reference's float expression, so region
bytes round alike); regions and phases equal field for field, but for the
zero-byte ``block{g}.kv`` accesses the reference lists for a model without
attention (``ROADMAP.md`` queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.core import policy as r_pol
from repro.core import topology as r_topo
from repro.core import tracer as r_tr
from repro.models.phases import build_regions_and_phases as r_build
import repro_torch.configs as TC
from repro_torch.core import policy as t_pol
from repro_torch.core import topology as t_topo
from repro_torch.core import tracer as t_tr
from repro_torch.models import Model
from repro_torch.models.phases import build_regions_and_phases as t_build

torch.set_num_threads(2)

WHICH = ("CONFIG", "SMOKE", "LONG")
# the reference's TPU- and XLA-only fields, which the port leaves out
# (remat and remat_policy_name are the port's too, compared below)
XLA_ONLY = ("cast_params_at_step", "fsdp_gather_at_layer", "scan_layers")
EVENT_COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")
# tests/test_arch_smoke.py::test_param_counts_hit_targets
TARGETS = {
    "mistral-large-123b": (123e9, 0.05),
    "chatglm3-6b": (6e9, 0.10),
    "starcoder2-3b": (3e9, 0.10),
    "qwen3-0.6b": (0.6e9, 0.15),
    "granite-moe-3b-a800m": (3.3e9, 0.10),
    "llama4-maverick-400b-a17b": (400e9, 0.05),
    "jamba-v0.1-52b": (52e9, 0.05),
    "mamba2-2.7b": (2.7e9, 0.05),
    "qwen2-vl-72b": (72e9, 0.05),
    "hubert-xlarge": (1e9, 0.15),
}


def _configs(arch, which):
    if which == "CONFIG":
        return RC.get_config(arch), TC.get_config(arch)
    if which == "SMOKE":
        return RC.get_smoke(arch), TC.get_smoke(arch)
    return RC.get_config(arch, "long_500k"), TC.get_config(arch, "long_500k")


def _kinds(arch):
    """The step kinds that ``cells()`` runs for ``arch``."""
    return sorted({RC.SHAPES[c["shape"]].kind for c in RC.cells()
                   if c["arch"] == arch and c["runnable"]})


def _allocated(regions, phases):
    """The reference's phases without its accesses to regions it never
    allocated (each must carry zero bytes)."""
    out = []
    for ph in phases:
        gone = [a for a in ph.accesses if a.region not in regions]
        assert all(a.bytes_ == 0 for a in gone)
        out.append(dataclasses.replace(
            ph, accesses=tuple(a for a in ph.accesses if a.region in regions)))
    return out


def _rows(phases):
    return [(p.name, p.flops, tuple(dataclasses.astuple(a) for a in p.accesses))
            for p in phases]


def _assert_programs_equal(r, t):
    (r_reg, r_ph), (t_reg, t_ph) = r, t
    assert [dataclasses.astuple(x) for x in r_reg] == [dataclasses.astuple(x) for x in t_reg]
    assert _rows(_allocated(r_reg, r_ph)) == _rows(t_ph)
    assert all(a.region in t_reg for p in t_ph for a in p.accesses)


def test_registry_equal():
    assert TC.ARCH_IDS == RC.ARCH_IDS and len(TC.ARCH_IDS) == 10
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}
    assert TC.cells() == RC.cells()
    cells = TC.cells()
    assert len(cells) == 40 and sum(c["runnable"] for c in cells) == 31
    assert all(c["skip"] for c in cells if not c["runnable"])
    for arch in TC.ARCH_IDS:
        for shape in (None, *TC.SHAPES):
            assert TC.get_config(arch, shape).name == RC.get_config(arch, shape).name


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_config_fields_equal(arch, which):
    """Every field the port keeps holds the reference's value (dtypes by
    name); the port leaves out exactly the TPU- and XLA-only fields."""
    r, t = _configs(arch, which)
    r_fields = {f.name for f in dataclasses.fields(r)}
    t_fields = {f.name for f in dataclasses.fields(t)}
    assert r_fields - t_fields == set(XLA_ONLY) and t_fields <= r_fields
    for name in sorted(t_fields):
        a, b = getattr(r, name), getattr(t, name)
        if name in ("dtype", "cache_dtype"):
            assert str(b).split(".")[-1] == np.dtype(a).name, name
        else:
            assert a == b, name


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_group_structure_and_param_counts_equal(arch, which):
    r, t = _configs(arch, which)
    assert t.group_spec() == r.group_spec()
    assert (t.n_groups, t.group_size) == (r.n_groups, r.group_size)
    assert (t.attn_layers_per_group, t.mamba_layers_per_group) == (
        r.attn_layers_per_group, r.mamba_layers_per_group)
    assert t.padded_vocab == r.padded_vocab
    rc, tc = r.param_counts(), t.param_counts()
    assert tc == rc  # total, active and expert, exactly
    assert all(type(v) is float for v in tc.values())
    if t.n_experts and t.top_k:
        assert 0 < tc["active"] < tc["total"] and tc["expert"] > 0
    else:
        assert tc["active"] == tc["total"]


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_param_counts_hit_targets(arch):
    want, tol = TARGETS[arch]
    got = TC.get_config(arch).param_counts()["total"]
    assert abs(got - want) / want < tol, f"{arch}: {got / want:.3f} of the target"


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_smoke_programs_equal(arch):
    """Each SMOKE config's memory program, for every step kind its cells
    run, is the reference's."""
    kinds = _kinds(arch)
    assert kinds == (["prefill", "train"] if arch == "hubert-xlarge"
                     else ["decode", "prefill", "train"])
    for kind in kinds:
        kw = dict(batch=2, seq=64, cache_len=128)
        _assert_programs_equal(r_build(RC.get_smoke(arch), kind, **kw),
                               t_build(TC.get_smoke(arch), kind, **kw))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_published_serving_programs_equal(arch):
    """The programs the card's model-zoo phase attaches: every CONFIG at
    decode (prefill for the encoder-only arch), batch 8, 4096 tokens, bf16
    weights — region bytes to the byte."""
    kind = "prefill" if arch == "hubert-xlarge" else "decode"
    kw = dict(batch=8, seq=4096, param_dtype_bytes=2)
    r, t = r_build(RC.get_config(arch), kind, **kw), t_build(TC.get_config(arch), kind, **kw)
    _assert_programs_equal(r, t)
    assert [p.flops for p in t[1]][-1] > 0


@pytest.mark.parametrize("arch", [a for a in RC.ARCH_IDS if a != "mamba2-2.7b"])
def test_smoke_program_traces_equal(arch):
    """Layer-epoch traces of each SMOKE serving program, placed alike,
    are the reference's bitwise (the ssm program's trace is the reference's
    repaired one, ``tests/test_torch_mamba2.py``)."""
    kind = "prefill" if arch == "hubert-xlarge" else "decode"
    kw = dict(batch=2, seq=64, cache_len=128)
    r_reg, r_ph = r_build(RC.get_smoke(arch), kind, **kw)
    t_reg, t_ph = t_build(TC.get_smoke(arch), kind, **kw)
    pol = {"param": "cxl_pool1", "kvcache": "cxl_pool2"}
    r_pol.ClassMapPolicy(pol).place(r_reg, r_topo.figure1_topology().flatten())
    t_pol.ClassMapPolicy(pol).place(t_reg, t_topo.figure1_topology().flatten())
    tkw = dict(granularity_bytes=64.0, max_events_per_access=64, epoch_mode="layer")
    r_trs, r_nat, r_names = r_tr.synthesize_step_trace(r_ph, r_reg, r_tr.TPU_V5E, **tkw)
    t_trs, t_nat, t_names = t_tr.synthesize_step_trace(t_ph, t_reg, t_tr.TPU_V5E, **tkw)
    assert r_nat == t_nat and r_names == t_names and len(r_trs) == len(t_trs)
    for r, t in zip(r_trs, t_trs):
        for c in EVENT_COLUMNS:
            a, b = getattr(r, c), getattr(t, c)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", [a for a in RC.ARCH_IDS if RC.get_config(a).family
                                  not in ("dense", "ssm", "moe", "hybrid")])
def test_forward_of_the_other_families_names_its_slice(arch):
    """The vlm and audio families are ported (tests/test_torch_vlm_audio.py
    holds their forward passes to the reference's): the SMOKE model and the
    published config on the meta device build every counted parameter."""
    for cfg, dev in ((TC.get_smoke(arch), "cpu"), (TC.get_config(arch), "meta")):
        model = Model(cfg, device=dev)
        assert sum(p.numel() for p in model.parameters()) == cfg.param_counts()["total"]
        assert model.device.type == dev


def _long_epochs(pkg, build, cfgs, quantum_ns=None):
    """llama4-maverick's decode program on Figure 1 (bf16 weights in
    cxl_pool1), as layer epochs or quantum epochs, in ``pkg``."""
    regions, phases = build(cfgs.get_config("llama4-maverick-400b-a17b"), "decode", batch=8,
                            seq=4096, param_dtype_bytes=2)
    flat = pkg.figure1_topology().flatten()
    pkg.ClassMapPolicy({"param": "cxl_pool1"}).place(regions, flat)
    kw = dict(granularity_bytes=64.0, max_events_per_access=1024)
    if quantum_ns is None:
        traces = pkg.synthesize_step_trace(phases, regions, pkg.TPU_V5E, epoch_mode="layer",
                                           **kw)[0]
    else:
        step = pkg.synthesize_step_trace(phases, regions, pkg.TPU_V5E, epoch_mode="step",
                                         **kw)[0]
        traces = [sl for tr in step for sl in pkg.EpochSchedule(
            "quantum", quantum_ns=quantum_ns).slices(tr)]
    return flat, traces


@pytest.mark.parametrize("quantum_ns", [None, float(2**22)])
def test_long_epochs_lose_f32_resolution_in_both_packages(quantum_ns):
    """Epoch-relative times are f32 in both analyzers.  llama4-maverick's
    layer epochs span about 41 ms here (TPU timing), where the f32 ulp is
    4 ns: the closed-form queue scan rounds starts past arrivals, and both
    packages report the same few hundred ns of congestion where the f64
    oracle reports none (ROADMAP.md queue 3).  Quantum epochs of 2**22 ns
    keep every time f32-exact, and both packages meet the oracle."""
    import repro.core as R
    from repro_torch import core as T

    r_flat, r_trs = _long_epochs(R, r_build, RC, quantum_ns)
    t_flat, t_trs = _long_epochs(T, t_build, TC, quantum_ns)
    assert len(r_trs) == len(t_trs)
    for r, t in zip(r_trs, t_trs):
        np.testing.assert_array_equal(r.t_ns, t.t_ns)
    span_ns = max(float(t.t_ns.max()) for t in t_trs)
    assert (span_ns > 2**23) == (quantum_ns is None)
    got = T.EpochAnalyzer(t_flat, device="cpu").analyze_batch(t_trs)
    want = R.EpochAnalyzer(r_flat).analyze_batch(r_trs)
    ref = None
    for tr in t_trs:
        span = max(float(tr.t_ns.max()) + 1.0, 1e4)
        b = T.analyze_ref(t_flat, tr, bw_window_ns=max(span / 128, 1.0), n_windows=128)
        ref = b if ref is None else ref + b
    assert ref.congestion_ns == 0.0
    assert got.congestion_ns == pytest.approx(want.congestion_ns, rel=1e-5)
    assert got.latency_ns == pytest.approx(ref.latency_ns, rel=1e-4)
    if quantum_ns is None:
        assert got.congestion_ns > 0.0 and want.congestion_ns > 0.0
    else:
        assert got.congestion_ns == want.congestion_ns == 0.0
