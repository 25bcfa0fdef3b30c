"""Port parity: the batched PyTorch ``EpochAnalyzer`` against the
reference's ``EpochAnalyzer(impl='inline')`` and against the f64 oracle
``analyze_ref``, on inputs carried across with ``repro_torch.interop``.

Totals agree to rel 1e-5 and per-switch sums to rtol 1e-5 / atol 1e-2 ns
against the reference analyzer: both sum f32 per-event delays, in different
orders.  Against the f64 oracle the bar is ``tests/test_fused_cascade.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import analyzer as r_an
from repro.core import events as r_ev
from repro.core import topology as r_topo
from repro_torch.core import analyzer as t_an
from repro_torch.core import events as t_ev
from repro_torch.core import topology as t_topo
from repro_torch.interop import flat_topology_from_arrays, mem_events_from_arrays
from repro_torch.kernels import ops as t_ops
from repro_torch.launch.mesh import make_data_mesh

torch.set_num_threads(2)

TOPOLOGIES = {
    "figure1": r_topo.figure1_topology,
    "two_tier": r_topo.two_tier_topology,
    "chain3": lambda: r_topo.chained_topology(3),
}


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _port(flat, traces):
    return (
        flat_topology_from_arrays(_fields(flat)),
        [mem_events_from_arrays(_fields(tr)) for tr in traces],
    )


def _traces(flat, burst, seed):
    # 4 KiB granules make the 32 GB/s links saturate in bursts, so the
    # bandwidth stage is exercised too
    return [
        r_ev.synthetic_trace(
            1200 + 400 * i, flat.n_pools, epoch_ns=2e5, seed=seed + i,
            burstiness=burst, granule_bytes=4096,
        )
        for i in range(3)
    ]


def _assert_breakdown_close(got, want, rel=1e-5, atol=1e-2):
    assert got.latency_ns == pytest.approx(want.latency_ns, rel=rel)
    assert got.congestion_ns == pytest.approx(want.congestion_ns, rel=rel)
    assert got.bandwidth_ns == pytest.approx(want.bandwidth_ns, rel=rel, abs=atol)
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=rel, atol=atol)


@pytest.mark.parametrize("burst", [0.0, 0.9], ids=["uniform", "bursty"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_analyzer_matches_reference_analyzer(topo, burst):
    flat = TOPOLOGIES[topo]().flatten()
    traces = _traces(flat, burst, seed=7)
    want = r_an.EpochAnalyzer(flat, impl="inline").analyze_batch(traces)
    t_flat, t_traces = _port(flat, traces)
    got = t_an.EpochAnalyzer(t_flat, device="cpu").analyze_batch(t_traces)
    _assert_breakdown_close(got, want)
    assert got.congestion_ns > 0
    if burst:
        assert got.bandwidth_ns > 0
    np.testing.assert_allclose(got.per_host_congestion_ns, [got.congestion_ns])
    np.testing.assert_allclose(got.per_class_congestion_ns, [got.congestion_ns])


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_analyzer_matches_f64_oracle(topo):
    """Per epoch against analyze_ref with the analyzer's effective window
    (span-scaled, ``n_windows`` static windows)."""
    flat = TOPOLOGIES[topo]().flatten()
    t_flat, t_traces = _port(flat, _traces(flat, 0.9, seed=3))
    an = t_an.EpochAnalyzer(t_flat, device="cpu")
    for tr in t_traces:
        got = an.analyze(tr)
        span = max(float(tr.t_ns.max()) + 1.0, an.bw_window_ns)
        ref = t_an.analyze_ref(
            t_flat, tr, bw_window_ns=max(span / an.n_windows, 1.0), n_windows=an.n_windows
        )
        assert got.latency_ns == pytest.approx(ref.latency_ns, rel=1e-4, abs=1e-3)
        assert got.congestion_ns == pytest.approx(ref.congestion_ns, rel=1e-3, abs=1e-2)
        assert got.bandwidth_ns == pytest.approx(ref.bandwidth_ns, rel=1e-2, abs=1.0)
        np.testing.assert_allclose(
            got.per_switch_congestion_ns, ref.per_switch_congestion_ns, rtol=2e-3, atol=0.1
        )


def test_oracles_are_the_reference_oracles():
    """analyze_ref and the DES are copies: equal to the reference's."""
    flat = r_topo.figure1_topology().flatten()
    tr = r_ev.synthetic_trace(1500, flat.n_pools, epoch_ns=1e5, seed=4, burstiness=0.6)
    t_flat, (t_tr,) = _port(flat, [tr])
    for kw in ({}, {"bw_window_ns": 500.0, "n_windows": 64}):
        a, b = r_an.analyze_ref(flat, tr, **kw), t_an.analyze_ref(t_flat, t_tr, **kw)
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    for mode in ("stt", "per_txn"):
        a = r_an.FineGrainedSimulator(flat, mode).simulate(tr)
        b = t_an.FineGrainedSimulator(t_flat, mode).simulate(t_tr)
        assert a.congestion_ns == b.congestion_ns and a.bandwidth_ns == b.bandwidth_ns


def test_empty_and_padded_batches():
    flat = r_topo.figure1_topology().flatten()
    traces = _traces(flat, 0.5, seed=1)
    t_flat, t_traces = _port(flat, traces)
    an = t_an.EpochAnalyzer(t_flat, device="cpu")
    zero = an.analyze_batch([])
    assert zero.total_ns == 0.0 and zero.per_switch_congestion_ns.shape == (3,)
    assert an.analyze_batch([t_ev.MemEvents.empty()]).total_ns == 0.0
    # 3 traces + 1 empty -> batch bucket 4 with one padded row
    batch = t_traces + [t_ev.MemEvents.empty()]
    got = an.analyze_batch(batch)
    assert an.last_dispatch.rows == 3 and an.last_dispatch.padded_fraction == 0.25
    want = r_an.EpochAnalyzer(flat, impl="inline").analyze_batch(traces)
    _assert_breakdown_close(got, want)
    # the batch equals the sum of its epochs
    parts = [an.analyze(tr) for tr in t_traces]
    assert got.total_ns == pytest.approx(sum(p.total_ns for p in parts), rel=1e-5)


def test_analyzer_runs_the_plain_cascade_on_cpu():
    from repro_torch.kernels import congestion as t_kernel

    flat = t_topo.figure1_topology().flatten()
    tr = t_ev.synthetic_trace(500, flat.n_pools, seed=2)
    plain0, kernel0 = t_ops.plain_launches, t_kernel.launches
    t_an.EpochAnalyzer(flat, device="cpu").analyze_batch([tr, tr])
    assert t_ops.plain_launches == plain0 + 1  # one batched call per batch
    assert t_kernel.launches == kernel0


def test_unported_options_name_their_slice():
    """Every option of the reference's analyzer is ported: ``mesh=`` takes
    a ``Mesh`` (beside the pipeline too), and the stacked multi-session
    dispatch runs with and without one and matches the reference's."""
    fig = t_topo.figure1_topology().flatten()
    for kw in (dict(flat=fig, pipeline=True, mesh=object()), dict(flat=fig, mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            t_an.EpochAnalyzer(device="cpu", **kw)
    mesh = make_data_mesh(2, "cpu", virtual=True)
    assert t_an.EpochAnalyzer(fig, device="cpu", pipeline=True, mesh=mesh).mesh is mesh
    r_fig = r_topo.figure1_topology().flatten()
    groups = [_traces(r_fig, 0.8, 20)[:2], [], _traces(r_fig, 0.5, 30)[:1]]
    want = r_an.EpochAnalyzer(r_fig).analyze_batch_multi(groups)
    an = t_an.EpochAnalyzer(fig, device="cpu")
    got = an.analyze_batch_multi([_port(r_fig, g)[1] for g in groups])
    assert an.analyze_batch_multi([]) == [] and got[1].total_ns == want[1].total_ns == 0.0
    for g, w in zip(got, want):
        _assert_breakdown_close(g, w)
    split = an.analyze_batch_multi([_port(r_fig, g)[1] for g in groups], mesh=mesh)
    assert an.last_dispatch.devices_used == 2 and an.sharded_dispatches == 1
    for g, w in zip(split, got):
        assert (g.latency_ns, g.congestion_ns, g.bandwidth_ns) == (
            w.latency_ns, w.congestion_ns, w.bandwidth_ns)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_an.EpochAnalyzer(t_topo.figure1_topology().flatten())
