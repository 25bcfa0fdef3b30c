"""Port parity: model configs, memory programs, placement and trace
synthesis — ``repro_torch`` against ``repro`` on the same inputs."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as r_qwen
from repro.core import policy as r_pol
from repro.core import timer as r_timer
from repro.core import topology as r_topo
from repro.core import tracer as r_tr
from repro.models.phases import build_regions_and_phases as r_build
from repro_torch.configs import qwen3_0_6b as t_qwen
from repro_torch.core import policy as t_pol
from repro_torch.core import timer as t_timer
from repro_torch.core import topology as t_topo
from repro_torch.core import tracer as t_tr
from repro_torch.interop import mem_events_from_arrays
from repro_torch.models import Model, ModelConfig
from repro_torch.models.phases import build_regions_and_phases as t_build

torch.set_num_threads(2)

EVENT_COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_param_counts_exact(which):
    r = getattr(r_qwen, which).param_counts()
    t = getattr(t_qwen, which).param_counts()
    assert r == t


def test_param_counts_other_families_name_their_slice():
    """The moe family's counts and memory program are ported (equal to the
    reference's, tests/test_torch_model_zoo.py), and its model builds every
    counted parameter (tests/test_torch_moe.py); so does the vlm family's
    (ported: tests/test_torch_vlm_audio.py)."""
    from repro.models import ModelConfig as RConfig

    cfg = ModelConfig("m", "moe", 2, 64, 4, 2, 128, 512, n_experts=4, top_k=2)
    assert cfg.param_counts() == RConfig("m", "moe", 2, 64, 4, 2, 128, 512, n_experts=4,
                                         top_k=2).param_counts()
    r_reg, _ = r_build(RConfig("m", "moe", 2, 64, 4, 2, 128, 512, n_experts=4, top_k=2),
                       "train", batch=1, seq=8)
    t_reg, _ = t_build(cfg, "train", batch=1, seq=8)
    assert [dataclasses.astuple(r) for r in r_reg] == [dataclasses.astuple(t) for t in t_reg]
    model = Model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_counts()["total"]
    vlm = dataclasses.replace(cfg, family="vlm")
    model = Model(vlm, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == vlm.param_counts()["total"]


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_regions_and_phases_equal(which, kind):
    kw = dict(batch=2, seq=64, cache_len=128)
    r_reg, r_ph = r_build(getattr(r_qwen, which), kind, **kw)
    t_reg, t_ph = t_build(getattr(t_qwen, which), kind, **kw)
    assert [dataclasses.astuple(r) for r in r_reg] == [
        dataclasses.astuple(t) for t in t_reg
    ]
    assert [(p.name, p.flops, tuple(dataclasses.astuple(a) for a in p.accesses))
            for p in r_ph] == [
        (p.name, p.flops, tuple(dataclasses.astuple(a) for a in p.accesses))
        for p in t_ph
    ]


def _policies(mod):
    return [
        mod.LocalOnlyPolicy(),
        mod.ClassMapPolicy({"opt_state": "cxl_pool2", "grad": "cxl_pool1"}),
        mod.InterleavePolicy(["cxl_pool1", "cxl_pool2", "cxl_pool3"], weights=[2, 1, 1]),
        mod.HotnessTieredPolicy("cxl_pool3", local_budget_bytes=1 << 16),
    ]


@pytest.mark.parametrize("k", range(4))
def test_policies_place_and_assign_equal(k):
    r_reg, _ = r_build(r_qwen.SMOKE, "train", batch=2, seq=64)
    t_reg, _ = t_build(t_qwen.SMOKE, "train", batch=2, seq=64)
    r_flat = r_topo.figure1_topology().flatten()
    t_flat = t_topo.figure1_topology().flatten()
    rp, tp = _policies(r_pol)[k], _policies(t_pol)[k]
    _bitwise(
        rp.assign(r_pol.RegionArrays.from_regions(r_reg), r_flat),
        tp.assign(t_pol.RegionArrays.from_regions(t_reg), t_flat),
    )
    rp.place(r_reg, r_flat)
    tp.place(t_reg, t_flat)
    _bitwise(r_reg.pool_vector(), t_reg.pool_vector())
    assert r_pol.capacity_check(r_reg, r_flat) == t_pol.capacity_check(t_reg, t_flat)
    assert rp.describe() == tp.describe() and rp.assign_key() == tp.assign_key()


@pytest.mark.parametrize("mode", ["step", "layer"])
def test_synthesize_step_trace_bitwise(mode):
    r_reg, r_ph = r_build(r_qwen.SMOKE, "train", batch=2, seq=64)
    t_reg, t_ph = t_build(t_qwen.SMOKE, "train", batch=2, seq=64)
    pol = {"opt_state": "cxl_pool2", "grad": "cxl_pool1"}
    r_pol.ClassMapPolicy(pol).place(r_reg, r_topo.figure1_topology().flatten())
    t_pol.ClassMapPolicy(pol).place(t_reg, t_topo.figure1_topology().flatten())
    kw = dict(granularity_bytes=64.0, max_events_per_access=256, epoch_mode=mode)
    r_trs, r_nat, r_names = r_tr.synthesize_step_trace(r_ph, r_reg, r_tr.TPU_V5E, **kw)
    t_trs, t_nat, t_names = t_tr.synthesize_step_trace(t_ph, t_reg, t_tr.TPU_V5E, **kw)
    assert r_nat == t_nat and r_names == t_names and len(r_trs) == len(t_trs)
    for r, t in zip(r_trs, t_trs):
        for c in EVENT_COLUMNS:
            _bitwise(getattr(r, c), getattr(t, c))


def test_quantum_slicing_bitwise():
    r = r_tr.synthesize_step_trace(
        *reversed(r_build(r_qwen.SMOKE, "train", batch=2, seq=64)),
        r_tr.TPU_V5E, max_events_per_access=128,
    )[0][0]
    t = mem_events_from_arrays({c: getattr(r, c) for c in EVENT_COLUMNS})
    q_ns = float(r.t_ns.max()) / 7.0
    for dense in (False, True):
        rs = r_timer.slice_by_quantum(r, q_ns, dense=dense)
        ts = t_timer.EpochSchedule("quantum", quantum_ns=q_ns).slices(t, dense=dense)
        assert len(rs) == len(ts)
        for a, b in zip(rs, ts):
            for c in EVENT_COLUMNS:
                _bitwise(getattr(a, c), getattr(b, c))


def test_hardware_models():
    assert dataclasses.astuple(t_tr.TPU_V5E) == dataclasses.astuple(r_tr.TPU_V5E)
    h = t_tr.H100_SXM
    assert (h.name, h.peak_flops, h.hbm_gbps, h.ici_gbps) == (
        "h100_sxm", 989e12, 3350.0, 450.0
    )
    ph = t_tr.Phase("p", flops=0.0, accesses=(t_tr.Access("w", 3350.0),))
    assert t_tr.phase_duration_ns(ph, h) == 1.0  # 3350 B at 3350 B/ns
