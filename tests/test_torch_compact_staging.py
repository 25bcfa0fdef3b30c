"""The analyzer's default dispatch path: compact staging
(``EventStager.stage_compact``), one copy of the real events, the padded
planes written on the device (``kernels.ops.expand_events``), and the
totals' copy back made at launch.

On the CPU the compact columns, expanded by the plain version, are held
bit for bit to the full-plane fill (``EventStager.stage``), and the
analyses to the full-plane path the default dispatch took before the
compact one: ``_run_batch`` over ``torch.from_numpy`` of ``stage()``'s
planes.  The tests marked ``cuda`` hold the expansion kernel to the plain
version and the whole path to the same full-plane analysis on the card; they
skip without one (``python -m pytest -m cuda tests/test_torch_compact_staging.py``
runs them there)."""

import numpy as np
import pytest
import torch

from repro_torch import core as T
from repro_torch.core import analyzer as t_an
from repro_torch.core import events as t_ev
from repro_torch.kernels import expand as t_expand
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref

torch.set_num_threads(2)

PLANES = ("t", "pool", "bytes", "weight", "host", "qos")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the expansion kernel runs only there")
    return torch.device("cuda")


def _bits(x) -> np.ndarray:
    """A plane's bit patterns (``-0.0`` and ``0.0`` differ here)."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint8) if x.dtype == bool else x.view(np.int32)


def _trace(rng, n, n_pools=3, n_hosts=2, monotone=True):
    t = rng.uniform(0.0, 1e6, n)
    if monotone:
        t.sort()
    else:
        t[: n // 2] = t[0]  # ties, so the stable argsort's order shows
    return T.MemEvents(
        t_ns=t,
        pool=rng.integers(0, n_pools, n).astype(np.int32),
        bytes_=rng.choice([64.0, 128.0, 4096.0], n),
        is_write=rng.random(n) < 0.3,
        region=np.zeros(n, np.int32),
        weight=rng.uniform(0.5, 2.0, n),
        host=rng.integers(0, n_hosts, n).astype(np.int32),
        qos=rng.integers(0, 3, n).astype(np.int32),
    )


def _batch(seed):
    """A ragged batch: an empty row, a non-monotone row, a one-event row."""
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(1, 300, 4)] + [0, 1]
    traces = [_trace(rng, n, monotone=i != 1) for i, n in enumerate(lens)]
    rng.shuffle(traces)
    return traces


def _expand_cpu(buf, n_bucket):
    """The compact slot's columns as CPU tensors through the plain expansion."""
    col = {name: torch.from_numpy(buf[name].copy()) for name in buf["layout"]}
    return dict(zip(PLANES + ("valid",), ref.expand_events(
        col["t"], col["offsets"], col["pool"], col["bytes"], col["weight"],
        col.get("host"), col.get("qos"), n_bucket, buf["longest"],
    )))


@pytest.mark.parametrize("hosts", [True, False], ids=["hosts", "one-host"])
@pytest.mark.parametrize("qos", [True, False], ids=["qos", "fifo"])
@pytest.mark.parametrize("extra_rows", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_staging_expands_to_the_full_planes_bitwise(seed, extra_rows, qos, hosts):
    traces = _batch(seed)
    b_bucket = len(traces) + extra_rows
    n_bucket = t_an.bucket_pow2(max(tr.n for tr in traces))
    want = t_ev.EventStager().stage(traces, b_bucket, n_bucket, qos=qos)
    buf = t_ev.EventStager().stage_compact(traces, b_bucket, 4, hosts=hosts, qos=qos)
    got = _expand_cpu(buf, n_bucket)
    for name in PLANES + ("valid",):
        if (name == "host" and not hosts) or (name == "qos" and not qos):
            assert got[name] is None and name not in buf["layout"], name
            continue
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)
    np.testing.assert_array_equal(buf["span"], want["span"])
    assert buf["offsets"][-1] == sum(tr.n for tr in traces)
    assert buf["n_words"] == max(b for _, b in buf["layout"].values())


def test_compact_words_hold_only_the_real_events_in_row_order():
    traces = _batch(7)
    buf = t_ev.EventStager().stage_compact(traces, 8, 2, hosts=True, qos=False)
    n = sum(tr.n for tr in traces)
    # offsets, window, scale, then the five columns of n events each
    assert buf["n_words"] == 9 + 8 + 8 * 2 + 5 * n
    assert list(buf["layout"]) == ["offsets", "window", "scale", "t", "pool", "bytes",
                                   "weight", "host"]
    rows = np.split(buf["t"], buf["offsets"][1:-1])
    for tr, row in zip(traces, rows):
        np.testing.assert_array_equal(row, np.sort(tr.t_ns, kind="stable").astype(np.float32))
    assert not any(len(r) for r in rows[len(traces):])


def test_compact_ring_waits_on_a_slots_copy_before_refilling_it():
    """Two slots: the fill of dispatch k+2 waits on dispatch k's fence,
    and on no other."""

    class Fence:
        def __init__(self):
            self.waited = 0

        def synchronize(self):
            self.waited += 1

    st = t_ev.EventStager(slots=2)
    traces = _batch(3)
    fences, slots = [], []
    for _ in range(4):
        buf = st.stage_compact(traces, 8, 2)
        slots.append(buf)
        fences.append(Fence())
        st.fence([buf], fences[-1])
    assert slots[0] is slots[2] and slots[1] is slots[3] and slots[0] is not slots[1]
    assert [f.waited for f in fences] == [1, 1, 0, 0]


def test_compact_ring_grows_and_decays_whole():
    st = t_ev.EventStager(slots=2)
    rng = np.random.default_rng(0)
    small, big = [_trace(rng, 100)], [_trace(rng, 20_000)]
    first = st.stage_compact(small, 1, 2)["words"]
    grown = st.stage_compact(big, 1, 2)["words"]
    assert grown.numel() > first.numel()
    sizes = [st.stage_compact(small, 1, 2)["words"].numel()
             for _ in range(t_ev.EventStager.CAP_DECAY_CALLS)]
    assert sizes[:-1] == [grown.numel()] * (len(sizes) - 1)  # held through the streak
    assert sizes[-1] == first.numel()  # then back to the streak's peak
    assert all(s["words"].numel() == first.numel() for s in st._compact[False])


def test_expansion_raises_on_a_row_longer_than_the_planes():
    t = torch.zeros(5)
    offsets = torch.tensor([0, 5], dtype=torch.int32)
    for expand in (ref.expand_events, t_ops.expand_events):
        with pytest.raises(ValueError, match="a row of 5 events exceeds the planes' 4 slots"):
            expand(t, offsets, t.int(), t, t, None, None, 4, 5)
    planes = t_ops.expand_events(t, offsets, t.int(), t, t, None, None, 5, 5)
    assert bool(planes[-1].all())  # a row that fills its planes exactly


def test_compact_columns_view_a_copy_of_the_words_by_section():
    traces = _batch(4)
    buf = t_ev.EventStager().stage_compact(traces, 8, 3, hosts=True, qos=True)
    assert buf["longest"] == max(tr.n for tr in traces)
    assert not buf["words"].is_pinned()  # a CPU dispatch's slot
    words = buf["words"][: buf["n_words"]].clone()
    col = t_ev.EventStager.compact_columns(buf, words)
    assert list(col) == list(buf["layout"])
    for name, x in col.items():
        assert x.data_ptr() >= words.data_ptr()  # views, no copies
        np.testing.assert_array_equal(x.numpy(), buf[name], err_msg=name)
        assert x.dtype == (torch.int32 if buf[name].dtype == np.int32 else torch.float32)


# --------------------------------------------------------------------------- #
# whole dispatches against the full-plane path
# --------------------------------------------------------------------------- #


def _full_plane(an, traces, lat_scales):
    """The default dispatch as it was before the compact path: ``stage()``'s
    planes, moved whole, analyzed by ``_run_batch``."""
    P, S, H = an.flat.n_pools, an.flat.n_switches, an.flat.n_hosts
    pairs = an._clean_pairs(traces, lat_scales)
    if not pairs:
        return t_an.DelayBreakdown.zero(P, S, H)
    trs = [tr for tr, _ in pairs]
    b_bucket = t_an.bucket_pow2(len(trs), floor=1)
    buf = t_ev.EventStager().stage(trs, b_bucket, t_an.bucket_pow2(max(tr.n for tr in trs)),
                                   qos=an.qos_on)
    scale = np.ones((b_bucket, H * P), np.float32)
    for row, (_, sc) in enumerate(pairs):
        if sc is not None:
            scale[row] = sc
    window = np.maximum(np.maximum(buf["span"], an.bw_window_ns) / an.n_windows,
                        1.0).astype(np.float32)

    def put(a):
        return torch.from_numpy(a).to(an.device)

    out = an._run_batch(
        put(buf["t"]), put(buf["pool"]), put(buf["bytes"]), put(buf["weight"]),
        put(buf["host"]) if H > 1 else None, put(buf["valid"]), put(window), put(scale),
        put(buf["qos"]) if an.qos_on else None,
    ).sum(dim=0)
    return t_an._unpack(out.cpu().numpy().astype(np.float64), P, S, H)


def _assert_bitwise(got, want):
    for f in ("latency_ns", "congestion_ns", "bandwidth_ns"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns",
              "per_host_latency_ns", "per_host_congestion_ns", "per_host_bandwidth_ns",
              "per_class_congestion_ns"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


class _Recorder:
    """Every default dispatch's arguments and finished breakdown."""

    def __init__(self, monkeypatch):
        self.calls = []
        launch, finish = t_an.EpochAnalyzer.launch_batch, t_an.PendingBatch.finish
        results = {}

        def recording_launch(an, traces, lat_scales=None, stager=None):
            pending = launch(an, traces, lat_scales, stager=stager)
            self.calls.append((an, list(traces), lat_scales, pending))
            return pending

        def recording_finish(pending):
            results[id(pending)] = bd = finish(pending)
            return bd

        monkeypatch.setattr(t_an.EpochAnalyzer, "launch_batch", recording_launch)
        monkeypatch.setattr(t_an.PendingBatch, "finish", recording_finish)
        self.results = results

    def check_against_full_plane(self):
        assert self.calls
        for an, traces, scales, pending in self.calls:
            _assert_bitwise(self.results[id(pending)], _full_plane(an, traces, scales))


def _regions():
    rm = T.RegionMap()
    rm.alloc("w", 1 << 22, "param")
    rm.alloc("kv", 1 << 22, "kvcache")
    phases = [T.Phase("fwd", flops=5e8, accesses=(T.Access("w", 1 << 22),
                                                  T.Access("kv", 1 << 22, True)))]
    return rm, phases


def _fabric(device, n_hosts=3, **kw):
    tenants = []
    for h in range(n_hosts):
        rm, phases = _regions()
        tenants.append(T.Tenant(f"t{h}", phases, rm, T.ClassMapPolicy({"kvcache": "shared_pool"})))
    return T.FabricSession(T.pooled_topology(n_hosts=n_hosts), tenants, device=device, **kw)


def _attached(device, **kw):
    rm, phases = _regions()
    sim = T.CXLMemSim(T.figure1_topology(), T.ClassMapPolicy({"kvcache": "cxl_pool2"}),
                      device=device, **kw)
    return sim.attach(lambda x: (x * x).sum(), phases, rm)


def _run(case, device, rounds, **kw):
    """A session's report after ``rounds`` rounds or steps."""
    if case == "pooled-fabric":
        with _fabric(device, **kw) as sess:
            return sess.run(rounds)
    with _attached(device, **kw) as prog:
        return prog.run(rounds, torch.ones(8, device=device))


@pytest.mark.parametrize("mode", ["async", "sync"])
@pytest.mark.parametrize("case", ["pooled-fabric", "single-host-attach"])
def test_launch_batch_matches_the_full_plane_path_bitwise(monkeypatch, case, mode):
    rec = _Recorder(monkeypatch)
    _run(case, "cpu", 2, async_analysis=mode == "async")
    rec.check_against_full_plane()


@pytest.mark.parametrize("topology", ["figure1", "qos-fabric", "one-host-pool"])
def test_analyze_batch_matches_the_full_plane_path_bitwise(topology):
    topo = {
        "figure1": T.figure1_topology,
        "qos-fabric": lambda: T.pooled_topology(n_hosts=2, discipline="wfq",
                                                class_weights=(4.0, 1.0)),
        "one-host-pool": lambda: T.pooled_topology(n_hosts=1),
    }[topology]()
    flat = topo.flatten()
    an = t_an.EpochAnalyzer(flat, n_windows=32, device="cpu")
    rng = np.random.default_rng(11)
    traces = [_trace(rng, n, n_pools=flat.n_pools, n_hosts=flat.n_hosts, monotone=n % 2 == 0)
              for n in (250, 0, 17, 400)]
    scales = [None, None, rng.uniform(0.5, 2.0, flat.n_hosts * flat.n_pools), None]
    for tr in traces:
        tr.qos[:] = tr.qos % flat.n_qos_classes
    _assert_bitwise(an.analyze_batch(traces, scales), _full_plane(an, traces, scales))
    assert an.qos_on == (topology == "qos-fabric")


def test_h2d_bytes_count_the_real_events_and_the_rows_and_fold_into_the_report(monkeypatch):
    rec = _Recorder(monkeypatch)
    with _fabric("cpu", async_analysis=False) as sess:
        rep = sess.run(2)
        flat = sess._analyzer.flat
    want = 0
    for an, traces, _, pending in rec.calls:
        b = t_an.bucket_pow2(len(traces), floor=1)
        n = sum(tr.n for tr in traces)
        # 20 B a real event (t, pool, bytes, weight, host), then the row
        # offsets, the window row and the scale rows
        per = 20 * n + 4 * (b + 1) + 4 * b + 4 * b * flat.n_hosts * flat.n_pools
        assert pending.stats.h2d_bytes == per
        want += per
    assert len(rec.calls) == 2 and rep.h2d_bytes == want > 0
    assert "h2d_bytes" not in rep.summary()  # the summary keeps the reference's keys


def test_the_default_path_fills_transfer_s_and_stays_off_the_plain_cascade_count():
    flat = T.pooled_topology(n_hosts=2).flatten()
    tr = t_ev.merge_host_traces([t_ev.synthetic_trace(300, 2, seed=h) for h in range(2)])
    an = t_an.EpochAnalyzer(flat, device="cpu")
    plain0, kernel0 = t_ops.plain_launches, t_expand.expand_launches
    pending = an.launch_batch([tr, tr])
    assert pending.ready is None  # the CPU's totals need no copy back
    pending.finish()
    st = an.last_dispatch
    assert st.transfer_s > 0 and st.stage_s > 0 and st.compute_s > 0
    assert st.h2d_bytes == 20 * 2 * tr.n + 4 * (3 + 2 + 2 * 2 * flat.n_pools)
    # one cascade call; the expansion is no cascade, and no kernel ran
    assert t_ops.plain_launches == plain0 + 1 and t_expand.expand_launches == kernel0


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("hosts,qos", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_expansion_kernel_matches_the_plain_version_bitwise(card, seed, hosts, qos):
    traces = _batch(seed)
    n_bucket = t_an.bucket_pow2(max(tr.n for tr in traces))
    buf = t_ev.EventStager().stage_compact(traces, len(traces) + 2, 4, hosts=hosts, qos=qos)
    want = _expand_cpu(buf, n_bucket)
    col = {name: torch.from_numpy(buf[name].copy()).to(card) for name in buf["layout"]}
    n0 = t_expand.expand_launches
    got = t_ops.expand_events(col["t"], col["offsets"], col["pool"], col["bytes"],
                              col["weight"], col.get("host"), col.get("qos"), n_bucket,
                              buf["longest"])
    torch.cuda.synchronize()
    assert t_expand.expand_launches == n0 + 1
    for name, g in zip(PLANES + ("valid",), got):
        assert (g is None) == (want[name] is None), name
        if g is not None:
            np.testing.assert_array_equal(_bits(g), _bits(want[name]), err_msg=name)


@pytest.mark.cuda
def test_expansion_kernel_at_the_pooled_fabrics_width(card):
    """One wide batch: rows of up to 2**19 events, three rows empty."""
    rng = np.random.default_rng(5)
    traces = [_trace(rng, n, n_pools=4, n_hosts=8) for n in (300_000, 1, 0, 524_288, 77)]
    n_bucket = t_an.bucket_pow2(max(tr.n for tr in traces))
    buf = t_ev.EventStager().stage_compact(traces, 8, 32, hosts=True, qos=False)
    want = _expand_cpu(buf, n_bucket)
    col = {name: torch.from_numpy(buf[name].copy()).to(card) for name in buf["layout"]}
    got = t_ops.expand_events(col["t"], col["offsets"], col["pool"], col["bytes"],
                              col["weight"], col["host"], None, n_bucket, buf["longest"])
    for name, g in zip(PLANES + ("valid",), got):
        if g is not None:
            assert torch.equal(g.cpu(), want[name]), name


@pytest.mark.cuda
def test_expansion_kernel_raises_on_a_row_longer_than_the_planes_without_a_launch(card):
    t = torch.zeros(5, device=card)
    offsets = torch.tensor([0, 5], dtype=torch.int32, device=card)
    n0 = t_expand.expand_launches
    with pytest.raises(ValueError, match="a row of 5 events exceeds the planes' 4 slots"):
        t_ops.expand_events(t, offsets, t.int(), t, t, None, None, 4, 5)
    assert t_expand.expand_launches == n0


@pytest.mark.cuda
def test_the_card_stages_pinned_and_fences_the_ring_with_the_copy(card, monkeypatch):
    fences = []
    fence = t_ev.EventStager.fence

    def recording_fence(st, bufs, done):
        fences.append(done)
        return fence(st, bufs, done)

    monkeypatch.setattr(t_ev.EventStager, "fence", recording_fence)
    flat = T.pooled_topology(n_hosts=2).flatten()
    tr = t_ev.merge_host_traces([t_ev.synthetic_trace(3000, 2, seed=h) for h in range(2)])
    an = t_an.EpochAnalyzer(flat, device=card)
    st = t_ev.EventStager(slots=2)
    waited = []
    ready = t_ev.EventStager._ready

    def recording_ready(stager, buf):
        waited.append(stager._fences.get(id(buf)))
        return ready(stager, buf)

    monkeypatch.setattr(t_ev.EventStager, "_ready", recording_ready)
    pend = [an.launch_batch([tr, tr], stager=st) for _ in range(3)]
    for p in pend:
        p.finish()
    slots = st._compact[True]
    assert all(s["words"].is_pinned() for s in slots)
    # the third fill took slot 0 again after waiting on the first copy's event
    assert waited[-1] is fences[0] and fences[0].query()
    assert all(p.stats.transfer_s > 0 for p in pend)


@pytest.mark.cuda
def test_a_pooled_fabric_session_on_the_card_matches_the_full_plane_path(card, monkeypatch):
    rec = _Recorder(monkeypatch)
    n0 = t_expand.expand_launches
    rep = _run("pooled-fabric", card, 3)
    assert t_expand.expand_launches - n0 == len(rec.calls) == 3  # one a dispatch
    rec.check_against_full_plane()
    assert rep.h2d_bytes > 0 and rep.transfer_s > 0
