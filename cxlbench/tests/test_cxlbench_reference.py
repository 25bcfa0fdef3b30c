"""The benchmark's plain references against the port's CPU path, on each
configuration's small sizes and short programs: the same topology
lowering, memory programs, event skeletons, placements, merged fabric
rounds, delays and forward pass.  (The tests import both; the references
import nothing of the port.)"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from cxlbench import inputs, run, system
from cxlbench.reference import model as ref_model
from cxlbench.reference import pricing, program
from cxlbench.tests.small import SMALL_DENSE, SMALL_MOE
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2
from repro_torch.core import (
    CoherencyConfig,
    EpochSchedule,
    FabricSession,
    H100_SXM,
    MemEvents,
    RegionArrays,
    Tenant,
    analyze_ref,
    figure1_topology,
    pooled_topology,
)
from repro_torch.core.tracer import synthesize_skeleton
from repro_torch.models import Model, build_regions_and_phases

FIG1 = run.resolve("starcoder2-3b.fig1.prefill")["config"]
POOL8 = run.resolve("granite-moe-3b-a800m.pool8.rounds")["config"]
SWEEP = run.resolve("starcoder2-3b.fig1.sweep")["traffic"]


def test_configurations_are_the_ports_own():
    # the port's starcoder2-3b with the published rope theta and layer norms
    assert system.model_config(FIG1["model"]) == dataclasses.replace(
        STARCODER2, rope_theta=999999.4420358813, norm="ln")
    assert system.model_config(POOL8["model"]) == GRANITE
    for cfg, topo in ((FIG1, figure1_topology()), (POOL8, pooled_topology(n_hosts=8))):
        a, b = program.flatten(cfg["topology"]), topo.flatten()
        np.testing.assert_array_equal(a["pool_latency_ns"], b.pool_latency_ns)
        np.testing.assert_array_equal(a["route"], b.route)
        np.testing.assert_array_equal(a["stt_ns"], b.switch_stt_ns)
        np.testing.assert_array_equal(a["bandwidth_gbps"], b.switch_bandwidth_gbps)
        np.testing.assert_array_equal(a["stage_order"], b.stage_order())
        np.testing.assert_array_equal(a["capacity"], b.pool_capacity)
        assert a["pool_names"] == b.pool_names and a["local_latency_ns"] == b.local_latency_ns


def test_sweep_overrides_lower_as_the_ports():
    for o in inputs.sweep_overrides(5, 0, SWEEP)[:4]:
        a = program.flatten(program.with_override(FIG1["topology"], o))
        b = system.topology(FIG1["topology"]).flatten_stack([system.override(o)])
        np.testing.assert_array_equal(a["pool_latency_ns"], b.pool_latency_ns[0])
        np.testing.assert_array_equal(a["stt_ns"], b.switch_stt_ns[0])
        np.testing.assert_array_equal(a["bandwidth_gbps"], b.switch_bandwidth_gbps[0])


@pytest.mark.parametrize("family,kind,cache_len", [
    ("dense", "prefill", 0), ("moe", "decode", 96), ("dense", "decode", 40)])
def test_memory_program_and_skeleton(family, kind, cache_len):
    m = dict(FIG1["model"] if family == "dense" else POOL8["model"])
    m.update(SMALL_DENSE if family == "dense" else SMALL_MOE)
    regions, phases = program.memory_program(m, kind, 3, 16 if kind == "prefill" else 1, cache_len)
    want_r, want_p = build_regions_and_phases(system.model_config(m), kind, batch=3,
                                              seq=16 if kind == "prefill" else 1,
                                              cache_len=cache_len)
    assert regions == [(r.name, r.nbytes, r.tensor_class) for r in want_r]
    assert [(n, f, [tuple(a) for a in acc]) for n, f, acc in phases] == [
        (p.name, p.flops, [(a.region, a.bytes_, a.is_write) for a in p.accesses]) for p in want_p]
    skel = program.skeleton(regions, phases, FIG1["pacing"], 64, 48)
    want = synthesize_skeleton(want_p, want_r, H100_SXM, granularity_bytes=64,
                               max_events_per_access=48, epoch_mode="layer")
    np.testing.assert_array_equal(skel["t"], want.t_ns)
    np.testing.assert_array_equal(skel["bytes"], want.bytes_)
    np.testing.assert_array_equal(skel["region"], want.region)
    np.testing.assert_array_equal(skel["write"], want.is_write)
    np.testing.assert_array_equal(skel["ptr"], want.epoch_ptr)


def test_placements_are_the_ports():
    m = dict(FIG1["model"], **SMALL_DENSE)
    regions, _ = program.memory_program(m, "prefill", 2, 32)
    want_r, _ = build_regions_and_phases(system.model_config(m), "prefill", batch=2, seq=32)
    flat = program.flatten(FIG1["topology"])
    port_flat = figure1_topology().flatten()
    total = sum(b for _, b, _ in regions)
    for pol in SWEEP["policies"] + [FIG1["placement"]]:
        got = program.place(pol, regions, flat)
        want = system.policy(pol, total).assign(RegionArrays.from_regions(want_r), port_flat)
        np.testing.assert_array_equal(got, want)


def _small_pool(hosts=3):
    cfg = copy.deepcopy(POOL8)
    cfg["model"].update(SMALL_MOE)
    cfg["tenants"].update(hosts=hosts, batch=4)
    cfg["topology"]["n_hosts"] = hosts
    cfg["events_per_access"] = 128
    return cfg


def test_merged_round_is_the_fabric_sessions():
    from cxlbench.drivers import fabric_rounds

    cfg = _small_pool()
    lens = [64, 96, 80]
    merged, miss, flat = fabric_rounds.rebuild(cfg, lens)
    tenants = []
    mcfg = system.model_config(cfg["model"])
    for h, cl in enumerate(lens):
        r, p = build_regions_and_phases(mcfg, "decode", batch=4, seq=1, cache_len=cl)
        tenants.append(Tenant(f"t{h}", p, r, system.policy(cfg["placement"])))
    coh = cfg["coherency"]
    sess = FabricSession(system.topology(cfg["topology"]), tenants, epoch=EpochSchedule("layer"),
                         hw=H100_SXM, coherency=CoherencyConfig(
                             shared_classes=tuple(coh["shared_classes"]),
                             max_bi_events=coh["max_bi_events"]),
                         max_events_per_access=128, async_analysis=False, device="cpu")
    want, want_miss, _ = sess._merged_round()
    np.testing.assert_array_equal(miss, want_miss)
    assert len(merged) == len(want)
    for got, w in zip(merged, want):
        np.testing.assert_array_equal(got["t"], w.t_ns)
        np.testing.assert_array_equal(got["pool"], w.pool)
        np.testing.assert_array_equal(got["host"], w.host)
        np.testing.assert_array_equal(got["bytes"], w.bytes_)
        np.testing.assert_array_equal(got["weight"], w.weight)
    # the delays of the merged epochs, as the port's own f64 oracle prices them
    port_flat = sess.flat
    for got, w in zip(merged, want):
        span = max(float(w.t_ns.max()) + 1.0, 10_000.0)
        bd = analyze_ref(port_flat, w, bw_window_ns=span / 128, n_windows=128)
        ours = pricing.price(flat, got, n_windows=128)
        np.testing.assert_allclose(ours["latency"], bd.latency_ns, rtol=1e-12)
        np.testing.assert_allclose(ours["congestion"], bd.congestion_ns, rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(ours["bandwidth"], bd.bandwidth_ns, rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(ours["host_congestion"], bd.per_host_congestion_ns,
                                   rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(ours["host_bandwidth"], bd.per_host_bandwidth_ns,
                                   rtol=1e-12, atol=1e-9)


def test_control_pricing_moves_every_delay():
    """One precision down (bf16 times, f32 sums) is visibly off on a
    lightly queued epoch, where f64 is the port's oracle's own."""
    rng = np.random.default_rng(0)
    n = 20000
    ev = {"t": np.sort(rng.uniform(0, 20.0 * n, n)), "pool": rng.integers(0, 4, n),
          "bytes": np.full(n, 4096.0), "write": np.zeros(n, bool), "region": np.zeros(n, np.int64),
          "weight": np.ones(n), "host": np.zeros(n, np.int64)}
    flat = program.flatten(FIG1["topology"])
    ref = pricing.price(flat, ev)
    port = analyze_ref(figure1_topology().flatten(), MemEvents(
        t_ns=ev["t"], pool=ev["pool"].astype(np.int32), bytes_=ev["bytes"], is_write=ev["write"],
        region=ev["region"].astype(np.int32)), bw_window_ns=(ev["t"].max() + 1) / 128, n_windows=128)
    assert ref["congestion"] == pytest.approx(port.congestion_ns, rel=1e-12)
    ctl = pricing.price(flat, ev, control=True)
    for k in ("latency", "congestion", "bandwidth"):
        assert abs(ctl[k] - ref[k]) > (1e-12 if k == "latency" else 1e-4) * abs(ref[k])


def test_reference_forward_is_the_ports_f32_model():
    m = dict(FIG1["model"], **SMALL_DENSE, dtype="float32", cache_dtype="float32")
    w = inputs.dense_weights(m, 3, "cpu")
    model = Model(system.model_config(m), device="meta")
    model.load_state_dict(w, assign=True)
    tokens = inputs.step_tokens(3, 0, 2, 24, m["vocab_size"], "cpu")
    got, _, _ = model.prefill(tokens)
    want = ref_model.last_logits(w, m, tokens)
    torch.testing.assert_close(got.float(), want, rtol=1e-4, atol=1e-4)
    f8 = ref_model.last_logits(w, m, tokens, fp8=True)
    assert ((f8 - want).abs().amax() / want.std()) > 0.05
