"""Port parity for the device-resident epoch pipeline: the merges and the
chain cascade (``two_run_merge``, ``staging_sort``, ``chain_cascade``), the
stager's ring slots and packed staging, ``plan_chain``, and
``EpochAnalyzer(pipeline=True)`` with its dispatch cache, against the
reference on the same numpy inputs, and its wiring through ``CXLMemSim``
and ``FabricSession``.

Bars: merges, sorts, packed planes, sticky caps and the chain cascade's
final times and slots bitwise the reference's (and a host stable argsort),
except where the reference's idle decay keeps caps that a stage held at the
floor has outgrown (the port grows them; a witness shows both);
per-stage delays to rel 1e-6 (both sum f32 delays, in different orders);
the card's formulation of each stage's scan (a masked scan over ``idx >=
0``, as ``ref.congestion_scan`` and the scan kernel's tiled mirror compute
it) bitwise the reference's ``arange`` formulation; pipeline analyses
against the port's default path and the reference's pipeline at
``tests/test_pipeline.py:251-253``'s rtol 1e-4, and against ``analyze_ref``
at its rtol 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import analyzer as r_an
from repro.core import events as r_ev
from repro.core import topology as r_topo
from repro.kernels import ref as r_ref
from repro_torch import core as T
from repro_torch.core import analyzer as t_an
from repro_torch.core import events as t_ev
from repro_torch.core import topology as t_topo
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch.mesh import make_data_mesh

torch.set_num_threads(2)

PAGE = 4096
COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")


def _host_stable(keys, *payloads):
    order = np.argsort(keys, kind="stable")
    return (np.asarray(keys)[order],) + tuple(np.asarray(p)[order] for p in payloads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# the merges
# --------------------------------------------------------------------------- #


def _two_runs(rng, w0, w1, span, pads0, pads1):
    a = np.sort(rng.integers(0, span, w0)).astype(np.float32)
    b = np.sort(rng.integers(0, span, w1)).astype(np.float32)
    a[w0 - pads0:] = np.inf
    b[w1 - pads1:] = np.inf
    ids = np.arange(w0 + w1, dtype=np.int32)
    ids[w0 - pads0:w0] = -1
    ids[w0 + w1 - pads1:] = -1
    return np.concatenate([a, b]), ids


@pytest.mark.parametrize("w0, w1, span, pads0, pads1", [
    (37, 27, 20, 5, 3),  # many exact ties, pads in both runs
    (16, 48, 1000, 0, 0),
    (33, 1, 4, 33, 1),  # both runs all pads
    (1, 40, 8, 0, 39),
])
def test_two_run_merge_bitwise_with_ties_and_pads(w0, w1, span, pads0, pads1):
    rng = np.random.default_rng(w0 * 100 + w1)
    rows = [_two_runs(rng, w0, w1, span, pads0, pads1) for _ in range(3)]
    x = np.stack([r[0] for r in rows])
    ids = np.stack([r[1] for r in rows])
    lead = np.arange(w0 + w1) < w0
    got_x, got_i = t_ref.two_run_merge(_t(x), _t(lead), _t(ids))
    for r in range(3):
        # host oracle: a stable argsort of the run-major concatenation
        # resolves ties lower-run-first, two_run_merge's tie rule
        exp_x, exp_i = _host_stable(x[r], ids[r])
        np.testing.assert_array_equal(got_x[r].numpy(), exp_x)
        np.testing.assert_array_equal(got_i[r].numpy(), exp_i)
        ref_x, ref_i = r_ref.two_run_merge(jnp.asarray(x[r]), jnp.asarray(lead),
                                           jnp.asarray(ids[r]))
        np.testing.assert_array_equal(got_x[r].numpy(), np.asarray(ref_x))
        np.testing.assert_array_equal(got_i[r].numpy(), np.asarray(ref_i))


def _runs(rng, caps, rows, span, min_fill=0):
    total = sum(caps)
    x = np.full((rows, total), np.inf, np.float32)
    idx = np.full((rows, total), -1, np.int32)
    off = 0
    for c in caps:
        for r in range(rows):
            fill = int(rng.integers(min(min_fill, c), c + 1))
            x[r, off:off + fill] = np.sort(rng.integers(0, span, fill)).astype(np.float32)
            idx[r, off:off + fill] = off + np.arange(fill, dtype=np.int32)
        off += c
    return x, idx


@pytest.mark.parametrize("caps", [(16,), (16, 16), (8, 16, 4), (8, 8, 8, 8, 8), (4, 0, 12, 0)])
def test_staging_sort_bitwise_vs_host_argsort_and_reference(caps):
    rng = np.random.default_rng(sum(caps) + len(caps))
    x, idx = _runs(rng, caps, 4, 12)
    got_x, got_i = t_ref.staging_sort(_t(x), caps, _t(idx))
    for r in range(4):
        # -1 pads all carry +inf keys; a stable argsort keeps them
        # run-ordered at the tail, as the merge tree does
        exp_x, exp_i = _host_stable(x[r], idx[r])
        np.testing.assert_array_equal(got_x[r].numpy(), exp_x)
        np.testing.assert_array_equal(got_i[r].numpy(), exp_i)
        ref_x, ref_i = r_ref.staging_sort(jnp.asarray(x[r]), caps, jnp.asarray(idx[r]))
        np.testing.assert_array_equal(got_x[r].numpy(), np.asarray(ref_x))
        np.testing.assert_array_equal(got_i[r].numpy(), np.asarray(ref_i))


def test_staging_sort_rejects_caps_that_do_not_tile():
    with pytest.raises(ValueError, match="do not tile"):
        t_ref.staging_sort(torch.zeros(2, 10), (4, 4))


# --------------------------------------------------------------------------- #
# the chain cascade
# --------------------------------------------------------------------------- #


STTS = np.asarray([7.0, 5.0, 3.0, 2.0], np.float32)


def _packed(rng, caps, rows, ties, all_pad_rows=()):
    """Per-stage packed sorted runs: ``ties`` draws integers from a small
    span; otherwise every row's times are distinct integers below 2**22
    (tie-free across segments).  Rows in ``all_pad_rows`` hold only pads."""
    W = sum(caps)
    t = np.full((rows, W), np.inf, np.float32)
    idx = np.full((rows, W), -1, np.int32)
    entry = np.full((rows, W), -1, np.int32)
    for r in range(rows):
        if r in all_pad_rows:
            continue
        pool = rng.choice(1 << 22, size=W, replace=False)
        off = 0
        for d, c in enumerate(caps):
            fill = int(rng.integers(1, c + 1)) if c else 0
            vals = rng.integers(0, max(2, W // 2), fill) if ties else pool[off:off + fill]
            t[r, off:off + fill] = np.sort(vals).astype(np.float32)
            idx[r, off:off + fill] = off + np.arange(fill, dtype=np.int32)
            entry[r, off:off + fill] = d
            off += c
    return t, idx, entry


CHAIN_CASES = {
    "tie_free": dict(caps=(8, 8, 16, 8), ties=False),
    "ties": dict(caps=(8, 8, 16, 8), ties=True),
    "empty_stage": dict(caps=(16, 0, 32, 8), ties=False),
    "empty_leading_stages": dict(caps=(0, 0, 32, 16), ties=True),
    "all_pad_row": dict(caps=(8, 16, 8, 8), ties=False, all_pad_rows=(1,)),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_cascade_matches_reference(case):
    kw = dict(CHAIN_CASES[case])
    caps = kw.pop("caps")
    t, idx, _ = _packed(np.random.default_rng(7), caps, 4, **kw)
    tf, i_fin, dsums = t_ref.chain_cascade(_t(t), _t(idx), STTS, caps)
    assert tf.shape == t.shape and i_fin.dtype == torch.int32 and dsums.shape == (4, 4)
    for r in range(4):
        rf, ri, rd = r_ref.chain_cascade(jnp.asarray(t[r]), jnp.asarray(idx[r]),
                                         jnp.asarray(STTS), caps)
        np.testing.assert_array_equal(tf[r].numpy(), np.asarray(rf))
        np.testing.assert_array_equal(i_fin[r].numpy(), np.asarray(ri))
        np.testing.assert_allclose(dsums[r].numpy(), np.asarray(rd), rtol=1e-6)
    if "all_pad_rows" in kw:
        assert bool(torch.isinf(tf[1]).all()) and bool((i_fin[1] == -1).all())
        assert float(dsums[1].abs().sum()) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_cascade_is_the_serial_cascade_on_tie_free_inputs(seed):
    """Per-event final times bitwise the port's full-width cascade with
    nested masks (stage s serves every event entering at depth <= s)."""
    caps = (8, 8, 16, 8)
    t, idx, entry = _packed(np.random.default_rng(seed), caps, 3, ties=False)
    tf, i_fin, dsums = t_ref.chain_cascade(_t(t), _t(idx), STTS, caps)
    for r in range(3):
        real = idx[r] >= 0
        order = np.argsort(t[r][real], kind="stable")
        ent = entry[r][real][order]
        bits = np.zeros_like(ent)
        for s in range(len(caps)):
            bits |= np.where(ent <= s, 1 << s, 0)
        sf, _, sd = t_ref.serial_queue_cascade(_t(t[r][real][order]), _t(bits), _t(STTS))
        got = {int(i): float(v) for i, v in zip(i_fin[r], tf[r]) if i >= 0}
        want = {int(i): float(v) for i, v in zip(idx[r][real][order], sf)}
        assert got == want
        np.testing.assert_allclose(dsums[r].numpy(), sd.numpy(), rtol=1e-6)


SCANS = {
    "congestion_scan": t_ref.congestion_scan,
    "scan_tiled": functools.partial(t_ref.congestion_scan_tiled, tile=8,
                                    generator=torch.Generator().manual_seed(3)),
}


@pytest.mark.parametrize("scan", sorted(SCANS))
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_card_formulation_is_the_arange_formulation_bitwise(case, scan):
    """The card runs each stage's scan as the scan kernel's masked scan over
    ``mask = idx >= 0``: real events form a prefix of every merged row, so
    the masked rank is the arange rank, and pads pass through."""
    kw = dict(CHAIN_CASES[case])
    caps = kw.pop("caps")
    t, idx, _ = _packed(np.random.default_rng(11), caps, 4, **kw)
    want = t_ref.chain_cascade(_t(t), _t(idx), STTS, caps)
    got = t_ref.chain_cascade(_t(t), _t(idx), STTS, caps, scan=SCANS[scan])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_chain_cascade_entry_point_runs_the_plain_version_on_cpu():
    caps = (8, 8, 16, 8)
    t, idx, _ = _packed(np.random.default_rng(5), caps, 2, ties=False)
    plain0 = t_ops.plain_launches
    got = t_ops.chain_cascade(_t(t), _t(idx), STTS.tolist(), caps)
    assert t_ops.plain_launches == plain0 + 1
    for g, w in zip(got, t_ref.chain_cascade(_t(t), _t(idx), STTS, caps)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="do not tile"):
        t_ops.chain_cascade(_t(t)[:, :-1], _t(idx)[:, :-1], STTS.tolist(), caps)


# --------------------------------------------------------------------------- #
# staging: ring slots and the packed (zero-argsort) path
# --------------------------------------------------------------------------- #


def _cols(rng, n, n_pools, probs=None, span=2e5, sort=True):
    t = rng.uniform(0, span, n)
    return dict(
        t_ns=np.sort(t) if sort else t,
        pool=rng.choice(n_pools, size=n, p=probs).astype(np.int32),
        bytes_=np.full((n,), 64.0),
        is_write=rng.random(n) < 0.3,
        region=np.zeros((n,), np.int32),
        weight=np.ones((n,)),
        host=np.zeros((n,), np.int32),
        qos=rng.integers(0, 2, n).astype(np.int32),
    )


def _both(cols):
    return (r_ev.MemEvents(**{k: v.copy() for k, v in cols.items()}),
            t_ev.MemEvents(**{k: v.copy() for k, v in cols.items()}))


def test_stager_ring_slots_do_not_alias():
    flat = T.two_tier_topology().flatten()
    st = T.EventStager(slots=2)
    rng = np.random.default_rng(1)
    b1 = st.stage([_both(_cols(rng, 100, flat.n_pools))[1]], 1, 128)
    b2 = st.stage([_both(_cols(rng, 100, flat.n_pools))[1]], 1, 128)
    assert b1["t"] is not b2["t"]  # double-buffered: a fill never clobbers
    b3 = st.stage([_both(_cols(rng, 100, flat.n_pools))[1]], 1, 128)
    assert b3["t"] is b1["t"]  # a ring of 2 wraps around


def test_stager_waits_on_a_slot_fence_before_refilling():
    class Fence:
        waited = 0

        def synchronize(self):
            Fence.waited += 1

    st = T.EventStager()
    tr = _both(_cols(np.random.default_rng(2), 50, 2))[1]
    buf = st.stage([tr], 1, 64)
    st.fence([buf], Fence())
    assert Fence.waited == 0
    st.stage([tr], 1, 64)
    assert Fence.waited == 1
    st.stage([tr], 1, 64)  # a fence is waited on once
    assert Fence.waited == 1


def test_stage_packed_equals_reference_over_growth_and_decay():
    """20 calls whose per-stage demand grows, then idles at under half the
    held caps: the planes and the sticky caps (the dispatch keys) are the
    reference's, bit for bit, and the idle decay shrinks them once."""
    flat = r_topo.chained_topology(3).flatten()
    plan = r_an.plan_chain(flat)
    rng = np.random.default_rng(3)
    r_st, t_st = r_ev.EventStager(np.float32), T.EventStager(np.float32)
    caps_seen = []
    for call in range(20):
        deep = min(0.9, 0.1 * (call + 1)) if call < 8 else 0.02
        probs = np.asarray([1.0 - deep, deep / 3, deep / 3, deep / 3])
        n = [600, 900, 700][call % 3]
        pairs = [_both(_cols(rng, n, flat.n_pools, probs=probs / probs.sum(),
                             sort=call % 4 != 1)) for _ in range(3)]
        r_buf, r_pack, r_caps = r_st.stage_packed([p[0] for p in pairs], 4, 1024,
                                                  plan.enter_stage, len(plan.stage_order))
        t_buf, t_pack, t_caps = t_st.stage_packed([p[1] for p in pairs], 4, 1024,
                                                  plan.enter_stage, len(plan.stage_order))
        assert t_caps == r_caps
        for k in ("t", "pool", "bytes", "weight", "host", "qos", "valid", "span"):
            assert t_buf[k].dtype == r_buf[k].dtype, k
            np.testing.assert_array_equal(t_buf[k], r_buf[k], err_msg=k)
        for k in ("t", "idx"):
            np.testing.assert_array_equal(t_pack[k], r_pack[k], err_msg=k)
        # the stager frees a superseded width's host sets
        assert {k[1] for k in t_st._pack_bufs} == {sum(t_caps)}
        caps_seen.append(t_caps)
    widths = [sum(c) for c in caps_seen]
    assert max(widths[:8]) > widths[-1]  # the idle streak decayed the caps
    assert widths[8:15] == [widths[7]] * 7  # held through the streak


def test_a_floor_held_stage_that_grows_is_not_idle():
    """The reference counts a stage held at the cap floor as idle whatever
    its demand, so when only that stage grows it keeps the held caps and
    the stage's events overrun into the next segment, which then
    overwrites them.  The port grows the caps instead: every routed event
    is packed once, in its own stage's segment."""
    flat = r_topo.chained_topology(3).flatten()
    plan = r_an.plan_chain(flat)
    enter, n_st = plan.enter_stage, len(plan.stage_order)
    pool_of = {int(enter[p]): p for p in range(flat.n_pools) if enter[p] >= 0}
    rng = np.random.default_rng(9)

    def trace(per_stage):
        pools = np.concatenate([np.full(n, pool_of[s], np.int32)
                                for s, n in per_stage.items()])
        c = _cols(rng, pools.shape[0], flat.n_pools)
        c["pool"] = rng.permutation(pools)
        return _both(c)

    r_st, t_st = r_ev.EventStager(np.float32), T.EventStager(np.float32)
    first = trace({1: 300, 2: 300})  # stage 0 held at the floor
    r_caps = r_st.stage_packed([first[0]], 1, 1024, enter, n_st)[2]
    assert t_st.stage_packed([first[1]], 1, 1024, enter, n_st)[2] == r_caps
    assert r_caps[0] == 16
    grow = trace({0: 100, 1: 20, 2: 20})
    _, r_pack, r_caps2 = r_st.stage_packed([grow[0]], 1, 1024, enter, n_st)
    t_buf, t_pack, t_caps = t_st.stage_packed([grow[1]], 1, 1024, enter, n_st)
    assert r_caps2 == r_caps  # held: stage 0's 100 events overrun its 16 slots
    assert int((r_pack["idx"] >= 0).sum()) < 140
    assert t_caps[0] == 128 and t_caps[1:] == r_caps[1:]
    off = np.cumsum((0,) + t_caps)
    d = enter[t_buf["pool"][0, :140]]
    for s in range(n_st):
        seg = t_pack["idx"][0, off[s]:off[s + 1]]
        np.testing.assert_array_equal(seg[seg >= 0], np.flatnonzero(d == s))


def test_stage_packed_segments_are_sorted_runs():
    flat = T.chained_topology(3).flatten()
    plan = T.plan_chain(flat)
    rng = np.random.default_rng(4)
    traces = [_both(_cols(rng, 200, flat.n_pools))[1] for _ in range(3)]
    buf, pack, caps = T.EventStager().stage_packed(
        traces, 4, 256, plan.enter_stage, len(plan.stage_order))
    assert sum(caps) == pack["t"].shape[1]
    off = 0
    for c in caps:
        seg = pack["t"][:, off:off + c]
        assert np.all(seg[:, 1:] >= seg[:, :-1])  # per-depth runs sorted for free
        off += c
    np.testing.assert_array_equal(pack["idx"] < 0, np.isinf(pack["t"]))


def _qos_topo(pkg):
    return pkg.pooled_topology(n_hosts=1, discipline="priority", class_weights=(1.0, 1.0))


PLAN_TOPOS = {
    "figure1": lambda pkg: pkg.figure1_topology(),
    "two_tier": lambda pkg: pkg.two_tier_topology(),
    "chained4": lambda pkg: pkg.chained_topology(4),
    "pooled2": lambda pkg: pkg.pooled_topology(n_hosts=2),
    "qos": _qos_topo,
}


@pytest.mark.parametrize("name", sorted(PLAN_TOPOS))
def test_plan_chain_agrees_with_reference(name):
    want = r_an.plan_chain(PLAN_TOPOS[name](r_topo).flatten())
    got = T.plan_chain(PLAN_TOPOS[name](t_topo).flatten())
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got.enter_stage, want.enter_stage)
        assert got.enter_stage.dtype == want.enter_stage.dtype
        assert got.stage_order == want.stage_order
    if name == "figure1":
        assert got.stage_order == (1, 0, 2)
        assert got.enter_stage.tolist() == [-1, 1, 0, 0]
    if name == "pooled2":
        assert got is None


# --------------------------------------------------------------------------- #
# the pipeline analyzer: parity, fallback, the dispatch cache
# --------------------------------------------------------------------------- #


def _traces(flat, seed, n0=1200, k=3):
    # 4 KiB granules in bursts: every stage queues and the links saturate
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        tr = r_ev.synthetic_trace(n0 + 400 * i, flat.n_pools, epoch_ns=2e5,
                               seed=int(rng.integers(1 << 30)), burstiness=0.9,
                               granule_bytes=4096)
        out.append(_both({c: getattr(tr, c) for c in COLUMNS}))
    return [p[0] for p in out], [p[1] for p in out]


def _close(got, want, rtol, per=True):
    for f in ("latency_ns", "congestion_ns", "bandwidth_ns"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=rtol), f
    if per:
        for f in ("per_pool_latency_ns", "per_switch_congestion_ns",
                  "per_switch_bandwidth_ns"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=rtol,
                                       atol=1e-2, err_msg=f)


PIPE_TOPOS = {
    "figure1": lambda pkg: pkg.figure1_topology(),
    "two_tier": lambda pkg: pkg.two_tier_topology(),
    "chained4": lambda pkg: pkg.chained_topology(4),
}


@pytest.mark.parametrize("name", sorted(PIPE_TOPOS))
def test_pipeline_matches_default_path_reference_and_oracle(name):
    r_flat = PIPE_TOPOS[name](r_topo).flatten()
    t_flat = PIPE_TOPOS[name](t_topo).flatten()
    r_tr, t_tr = _traces(r_flat, 10)
    base = T.EpochAnalyzer(t_flat, n_windows=32, device="cpu")
    pipe = T.EpochAnalyzer(t_flat, n_windows=32, device="cpu", pipeline=True)
    a = base.analyze_batch(t_tr)
    b = pipe.analyze_batch(t_tr)
    assert not pipe.last_dispatch.donated and pipe._chain_plan is not None
    assert b.congestion_ns > 0 and b.bandwidth_ns > 0
    assert b.latency_ns == a.latency_ns  # the same gather on the same planes
    _close(b, a, 1e-4)
    want = r_an.EpochAnalyzer(r_flat, n_windows=32, pipeline=True).analyze_batch(r_tr)
    _close(b, want, 1e-4)
    # the f64 oracle, with the analyzer's span-scaled windows
    ref_tot = 0.0
    for tr in r_tr:
        span = max(float(tr.t_ns.max()) + 1.0, 10_000.0)
        ref_tot += r_an.analyze_ref(r_flat, tr, n_windows=32,
                                    bw_window_ns=max(span / 32, 1.0)).total_ns
    assert b.total_ns == pytest.approx(ref_tot, rel=1e-3)


@pytest.mark.parametrize("name", ["pooled2", "qos"])
def test_pipeline_off_the_chain_runs_the_full_plane_path(name):
    """Multi-host fabrics and QoS topologies run the default path's
    analysis from the dispatch cache's buffers: equal to it, no donation."""
    t_flat = PLAN_TOPOS[name](t_topo).flatten()
    rng = np.random.default_rng(6)
    cols = [_cols(rng, 256, t_flat.n_pools, span=2e3) for _ in range(2)]
    for h, c in enumerate(cols):
        c["host"][:] = h if t_flat.n_hosts > 1 else 0
    traces = [_both(c)[1] for c in cols]
    if t_flat.n_hosts > 1:
        traces = [T.merge_host_traces(traces)]
    base = T.EpochAnalyzer(t_flat, n_windows=32, device="cpu")
    pipe = T.EpochAnalyzer(t_flat, n_windows=32, device="cpu", pipeline=True)
    a, b = base.analyze_batch(traces), pipe.analyze_batch(traces)
    assert pipe._chain_plan is None
    assert a.congestion_ns > 0
    for f in ("latency_ns", "congestion_ns", "bandwidth_ns"):
        assert getattr(b, f) == getattr(a, f), f
    for f in ("per_host_congestion_ns", "per_class_congestion_ns"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    st = pipe.last_dispatch
    assert st.donated is False and st.compute_s >= 0.0
    assert st.qos_classes == t_flat.n_qos_classes


def test_a_change_of_caps_reuses_the_buckets_full_planes():
    """New held caps make a new dispatch key, as in the reference, but each
    key's entry is its bucket's ring: no full plane is allocated again, the
    packed device buffers grow only past the widest caps yet (not when the
    idle decay shrinks them), and they hold the staged pack."""
    flat = T.chained_topology(3).flatten()
    pipe = T.EpochAnalyzer(flat, n_windows=32, device="cpu", pipeline=True)
    rng = np.random.default_rng(8)

    def batch(deep):
        probs = np.asarray([1.0 - deep, deep / 3, deep / 3, deep / 3])
        return [_both(_cols(rng, 700, flat.n_pools, probs=probs))[1] for _ in range(3)]

    pipe.analyze_batch(batch(0.05))
    (ring,) = pipe._rings.values()
    ptrs = {k: v.data_ptr() for k, v in ring.planes.items()}
    flats = [ring.flat["t"]]
    for deep in [0.5, 0.9] + [0.02] * 8:  # two growths, then an idle decay
        pipe.analyze_batch(batch(deep))
        if ring.flat["t"] is not flats[-1]:
            flats.append(ring.flat["t"])
    keys = list(pipe._aot._cache)
    assert len(keys) == pipe._aot.lowerings == 3  # the ramp's three caps
    assert {k[:3] for k in keys} == {("chain", 4, 1024)}
    assert len(pipe._rings) == 1 and all(pipe._aot._cache[k] is ring for k in keys)
    assert {k: v.data_ptr() for k, v in ring.planes.items()} == ptrs
    assert len(flats) == 3  # grown twice, kept through the decay
    # the decay went back to the first caps: a hit on their key
    (caps,) = pipe._stager._cap_hwm.values()
    assert caps == keys[0][3] and pipe.last_dispatch.aot_cache_hit
    width = sum(caps)
    assert width < sum(keys[-1][3])
    # the stager keeps only the held width's host sets
    (pack,) = [b for k, b in pipe._stager._pack_bufs.items() if k[:2] == (4, width)]
    assert {k[1] for k in pipe._stager._pack_bufs} == {width}
    dev = ring.packed(4, width)
    assert dev["t"].is_contiguous() and dev["t"].shape == (4, width)
    assert torch.equal(dev["t"], _t(pack["t"])) and torch.equal(dev["idx"], _t(pack["idx"]))
    assert not pipe.last_dispatch.donated


def test_dispatch_cache_steady_state_and_warmup():
    """``tests/test_pipeline.py``'s steady-state case on the port: no build
    over 50 dispatches after a 5-call ramp of the sticky caps."""
    flat = t_topo.chained_topology(3).flatten()
    pipe = T.EpochAnalyzer(flat, n_windows=32, device="cpu", pipeline=True)

    def trace(n, seed):
        return T.synthetic_trace(n, flat.n_pools, seed=seed)

    warm = [trace(180, 99)]
    assert pipe.warmup(warm) is True
    assert pipe.warmup(warm) is False  # already warm
    # a short ramp lets the sticky per-stage caps reach their high-water
    # mark; after that the dispatch key is fixed
    for i in range(5):
        pipe.analyze_batch([trace(150 + 10 * i, 1000 + i)])
    base = pipe._aot.lowerings
    hits = pipe._aot.hits
    for i in range(50):
        pipe.analyze_batch([trace(150 + (i % 50), i)])
    assert pipe._aot.lowerings == base, "steady state must not rebuild"
    assert pipe._aot.hits - hits >= 50 and len(pipe._aot) == base


def test_warmup_does_nothing_on_a_non_pipeline_analyzer():
    flat = T.two_tier_topology().flatten()
    base = T.EpochAnalyzer(flat, n_windows=32, device="cpu")
    before = base.last_dispatch
    plain0 = t_ops.plain_launches
    assert base.warmup([_both(_cols(np.random.default_rng(0), 64, 2))[1]]) is False
    assert base.last_dispatch is before and t_ops.plain_launches == plain0


def test_dispatch_stats_timing_fields_filled():
    flat = T.chained_topology(3).flatten()
    pipe = T.EpochAnalyzer(flat, n_windows=32, device="cpu", pipeline=True)
    _, traces = _traces(flat, 12, n0=300, k=1)
    pipe.analyze_batch(traces)
    st = pipe.last_dispatch
    assert isinstance(st, t_an.DispatchStats)
    assert st.stage_s > 0 and st.transfer_s > 0 and st.compute_s > 0
    assert st.compile_s > 0 and not st.aot_cache_hit  # the first dispatch builds
    assert st.rows == 1 and st.devices_used == 1
    pipe.analyze_batch(traces)
    assert pipe.last_dispatch.compile_s == 0.0 and pipe.last_dispatch.aot_cache_hit
    # the default path leaves the split at its defaults
    base = T.EpochAnalyzer(flat, n_windows=32, device="cpu")
    base.analyze_batch(traces)
    d = base.last_dispatch
    assert (d.stage_s, d.transfer_s, d.compile_s, d.compute_s) == (0.0, 0.0, 0.0, 0.0)
    assert not d.donated and not d.aot_cache_hit and d.rows == 1


def test_launches_resolve_in_any_order_and_empty_batches_are_zero():
    flat = T.figure1_topology().flatten()
    pipe = T.EpochAnalyzer(flat, n_windows=32, device="cpu", pipeline=True)
    _, tr1 = _traces(flat, 21, k=2)
    _, tr2 = _traces(flat, 22, k=2)
    p1, p2 = pipe.launch_batch(tr1), pipe.launch_batch(tr2)
    b2, b1 = p2.finish(), p1.finish()
    base = T.EpochAnalyzer(flat, n_windows=32, device="cpu")
    _close(b1, base.analyze_batch(tr1), 1e-4)
    _close(b2, base.analyze_batch(tr2), 1e-4)
    empty = pipe.launch_batch([])
    assert isinstance(empty, T.PendingBatch)
    assert empty.finish().total_ns == 0.0 and pipe.last_dispatch.rows == 0


# --------------------------------------------------------------------------- #
# CXLMemSim(pipeline=, warmup=) and FabricSession(pipeline=)
# --------------------------------------------------------------------------- #


def _attached(pkg, pipeline, migration=False, cache=False):
    """A figure1 program whose two access trains share one time grid, so
    events entering the chain at different depths tie exactly."""
    rm = pkg.RegionMap()
    rm.alloc("w", 1 << 20, "param")
    rm.alloc("kv", 64 * PAGE, "kvcache")
    phases = [pkg.Phase("fwd", flops=5e7, accesses=(
        pkg.Access("w", 1 << 20), pkg.Access("kv", 1 << 23, True)))]
    topo = pkg.figure1_topology()
    kw = dict(pipeline=pipeline, warmup=pipeline)
    if pkg is T:
        step = lambda a: (a * 2).sum()  # noqa: E731
        kw["device"] = "cpu"
    else:
        step = jax.jit(lambda a: (a * 2).sum())
        kw["async_analysis"] = False
    if migration:
        kw["migration"] = pkg.MigrationSimulator(
            pkg.MigrationConfig(mode="software", promote_threshold=1,
                                local_budget_bytes=1 << 30, demote_pool="cxl_pool2"),
            rm, topo.flatten())
    if cache:
        kw["cache"] = pkg.DeviceCacheConfig(capacity_bytes=1 << 22, line_bytes=PAGE)
    sim = pkg.CXLMemSim(topo, pkg.ClassMapPolicy({"kvcache": "cxl_pool2", "param": "cxl_pool1"}),
                        hw=pkg.TPU_V5E, **kw)
    return sim.attach(step, phases, rm)


def _run_attach(pkg, pipeline, **kw):
    x = torch.ones(32) if pkg is T else jnp.ones((32,))
    with _attached(pkg, pipeline, **kw) as prog:
        if pipeline:  # warmup=True built the dispatch-cache entry at attach
            assert prog._analyzer.pipeline and prog._analyzer._aot.lowerings == 1
        return prog.run(3, x)


@pytest.mark.parametrize("variant", ["plain", "migration", "cache", "migration+cache"])
def test_cxlmemsim_pipeline_matches_reference_and_default_path(variant):
    kw = dict(migration="migration" in variant, cache="cache" in variant)
    got = _run_attach(T, True, **kw)
    base = _run_attach(T, False, **kw)
    want = _run_attach(R, True, **kw)
    assert got.epochs == base.epochs == want.epochs == 3 and got.congestion_s > 0
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-4), f
    assert got.migration_moved_bytes == base.migration_moved_bytes
    assert got.cache_hit_fraction == base.cache_hit_fraction or (
        np.isnan(got.cache_hit_fraction) and np.isnan(base.cache_hit_fraction))
    # against the default path: the same latency gather, the same queueing
    # sums; the chain cascade serves exact cross-depth ties in another
    # (equally FIFO) order, which moves a few events across a bandwidth
    # window, in the reference as here (test below): bandwidth holds to
    # the f64 oracle's bar, which the default path meets
    assert got.latency_s == base.latency_s
    assert got.congestion_s == pytest.approx(base.congestion_s, rel=1e-5)
    assert got.bandwidth_s == pytest.approx(base.bandwidth_s, rel=1e-2)
    assert got.donated_dispatches == base.donated_dispatches == 0
    if variant == "plain":  # shapes are fixed: every dispatch hits the warm entry
        assert got.aot_cache_hits == 3 and got.compile_s == 0.0
    assert got.stage_s > 0 and got.transfer_s > 0 and base.transfer_s == 0.0


def test_cross_depth_ties_move_bandwidth_alike_in_both_packages():
    """On epochs whose trains tie exactly across entry depths, both
    packages' pipelines part from their full-width paths by the same
    bandwidth, and agree with each other; congestion sums stay equal."""
    epochs = _attached(T, False).epoch_traces()
    r_epochs = [r_ev.MemEvents(**{c: getattr(tr, c).copy() for c in COLUMNS})
                for tr in epochs]
    t_flat, r_flat = t_topo.figure1_topology().flatten(), r_topo.figure1_topology().flatten()
    got = {p: T.EpochAnalyzer(t_flat, device="cpu", pipeline=p).analyze_batch(epochs)
           for p in (False, True)}
    want = {p: r_an.EpochAnalyzer(r_flat, pipeline=p).analyze_batch(r_epochs)
            for p in (False, True)}
    for p in (False, True):
        _close(got[p], want[p], 1e-5)
    assert got[True].congestion_ns == got[False].congestion_ns > 0
    moved = got[True].bandwidth_ns / got[False].bandwidth_ns - 1.0
    assert moved != 0.0 and abs(moved) < 1e-2
    assert want[True].bandwidth_ns / want[False].bandwidth_ns - 1.0 == pytest.approx(
        moved, rel=1e-3)


def _tenant(name, kv_pages):
    rm = T.RegionMap()
    rm.alloc("kv_" + name, kv_pages * PAGE, "kvcache")
    rm.alloc("act_" + name, 1 << 18, "activation")
    phases = [T.Phase("fwd", flops=5e8,
                      accesses=(T.Access("kv_" + name, 64 * kv_pages * PAGE, True),
                                T.Access("act_" + name, 1 << 18)))]
    return T.Tenant(name, phases, rm, T.ClassMapPolicy({"kvcache": "shared_pool"}))


@pytest.mark.parametrize("variant", ["fifo", "migration+cache", "qos"])
def test_fabric_session_pipeline_matches_the_default_path(variant):
    reps = {}
    for pipeline in (False, True):
        kw = {}
        topo = T.pooled_topology(n_hosts=2, cxl_bandwidth_gbps=8.0)
        if variant == "qos":
            topo = T.pooled_topology(n_hosts=2, cxl_bandwidth_gbps=8.0,
                                     discipline="priority", class_weights=(1.0, 1.0))
        if variant == "migration+cache":
            kw["migration"] = T.MigrationConfig(mode="software", promote_threshold=2,
                                                local_budget_bytes=1 << 32)
            kw["cache"] = T.DeviceCacheConfig(capacity_bytes=1 << 24, line_bytes=PAGE)
        with T.FabricSession(topo, [_tenant("a", 64), _tenant("b", 32)], hw=T.TPU_V5E,
                             device="cpu", pipeline=pipeline, **kw) as sess:
            sess.run(2)
            reps[pipeline] = sess.report
    got, want = reps[True], reps[False]
    assert got.rounds == want.rounds == 2 and got.congestion_s > 0
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == getattr(want, f), f
    for hg, hw in zip(got.hosts, want.hosts):
        assert hg.congestion_s == hw.congestion_s and hg.latency_s == hw.latency_s
    assert got.donated_dispatches == 0 and got.compile_s > 0
    if variant != "migration+cache":  # replayed rounds: the second one hits
        assert got.aot_cache_hits == 1


def test_pipeline_options_still_unported_beside_it():
    """The stacked dispatch and asynchronous analysis (slice 4) now run
    beside the pipeline (the test keeps its name): a pipeline analyzer's
    ``analyze_batch_multi`` takes the full-plane stacked path, as the
    reference's does, and matches the reference's; an asynchronous
    pipeline attach equals the synchronous one.  ``mesh=`` (slice 18) runs
    beside it too: the split stacked dispatch equals the unsplit one, and
    a mesh that is not a ``Mesh`` raises."""
    fig = T.figure1_topology()
    pipe = T.EpochAnalyzer(fig.flatten(), device="cpu", pipeline=True)
    assert pipe.analyze_batch_multi([]) == []
    epochs = _attached(T, False).epoch_traces()
    r_epochs = [r_ev.MemEvents(**{c: getattr(tr, c).copy() for c in COLUMNS})
                for tr in epochs]
    got = pipe.analyze_batch_multi([epochs, epochs[:1]])
    want = r_an.EpochAnalyzer(r_topo.figure1_topology().flatten(), pipeline=True
                              ).analyze_batch_multi([r_epochs, r_epochs[:1]])
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    with T.AnalysisEngine() as eng:
        reps = {}
        for asy in (False, True):
            sim = T.CXLMemSim(fig, T.ClassMapPolicy({"kvcache": "cxl_pool2"}), device="cpu",
                              pipeline=True, warmup=True, async_analysis=asy, engine=eng)
            prog = _attached(T, False)
            with sim.attach(prog.step_fn, prog.phases, prog.regions) as run:
                assert (run._handle is not None) == asy
                reps[asy] = run.run(3, torch.ones(32))
        for f in ("latency_s", "congestion_s", "bandwidth_s"):
            assert getattr(reps[True], f) == getattr(reps[False], f), f
        assert reps[True].aot_cache_hits == reps[False].aot_cache_hits == 3
    split = T.EpochAnalyzer(fig.flatten(), device="cpu", pipeline=True,
                            mesh=make_data_mesh(2, "cpu", virtual=True))
    for g, w in zip(split.analyze_batch_multi([epochs, epochs[:1]]), got):
        assert (g.latency_ns, g.congestion_ns, g.bandwidth_ns) == (
            w.latency_ns, w.congestion_ns, w.bandwidth_ns)
    assert split.last_dispatch.devices_used == 2 and split.sharded_dispatches == 1
    with pytest.raises(TypeError, match="Mesh"):
        T.EpochAnalyzer(fig.flatten(), device="cpu", pipeline=True, mesh=object())
