#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the kernel libraries (congestion_cascade.cu: the single-host and
   host-segmented cascades; congestion_scan.cu: the single-switch scan),
   one nvcc per source, all started together, from the repository's
   sources into build/repro_torch_kernels/;
3. kernels vs plain, each on the same CUDA inputs as its plain PyTorch
   version, with median times over CUDA events:
   - the cascade at [4, 3000] S=3, [32, 131072] with figure1's stages,
     [8, 65536] with chained_topology(8)'s nine stages and the slice-1 main
     path's own batch: slot indices exactly equal, final times to rtol
     1e-6, per-stage delays to rtol 1e-5;
   - the host-segmented cascade at [4, 3000] on figure1 re-declared for 3
     hosts, [32, 131072] on pooled_topology(n_hosts=8) and the fabric
     round's own batch: as above, per-host delays to rtol 1e-5, and their
     sum over hosts equal to the single-host kernel's delays to rtol 1e-6;
   - the scan at [32, 131072] with a random mask and on one stage of the
     wide fabric's batch: start and delay to rtol 1e-6;
4. slice-1 main path: CXLMemSim attached to a bf16 stand-in step on the
   card, with the qwen3-0.6b published config's layer-epoch trace (8 x 4096
   tokens) on the paper's Figure 1 topology, one warm-up step, then 3
   measured steps; over those 3 the cascade's launch count must rise by
   exactly 3 and the plain path's by 0, the report's delay totals must
   match the f64 oracle ``analyze_ref``, and both switches must queue; then
   host staging on the host clock, and a torch.profiler table of one batch;
5. the shared fabric: FabricSession with 8 trace-only qwen3-0.6b decode
   tenants (batch 64, 4096-token caches) pooling their KV caches on
   pooled_topology(n_hosts=8) with trace-driven coherency, one warm-up
   round, then 3 measured rounds; over those 3 the host-segmented kernel's
   launch count must rise by exactly 3, the plain path's and the
   single-host kernel's by 0; totals and the per-host decomposition must
   match ``analyze_ref`` on the merged epochs; then the host time of the
   merge and of staging, and a torch.profiler table of one round's batch;
6. the wide fabric: 32 smaller decode tenants on pooled_topology(n_hosts=32),
   33 stages, over the 31-bit route word, so the analyzer runs the unfused
   per-stage loop: 2 rounds, the scan's launch count must rise by stages x
   rounds and the plain path's by 0, and the totals must match
   ``analyze_ref``;
7. a JSON ``kernels`` line, then the card's nvidia-smi line, then the result
   line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.qwen3_0_6b import CONFIG  # noqa: E402
from repro_torch.core import (  # noqa: E402
    H100_SXM,
    ClassMapPolicy,
    CoherencyConfig,
    CXLMemSim,
    EpochSchedule,
    EventStager,
    FabricSession,
    Tenant,
    Topology,
    analyze_ref,
    bucket_pow2,
    chained_topology,
    figure1_topology,
    plan_cascade,
    pooled_topology,
)
from repro_torch.core.units import s_to_ns  # noqa: E402
from repro_torch.kernels import congestion as kcong  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import build_regions_and_phases  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
MS_PER_S = 1e3
BYTES_PER_EVENT = 16  # cascade: read t + route bits, write t_final + slot_idx
HOSTS_BYTES_PER_EVENT = 20  # hosts cascade: + read the host id
SCAN_BYTES_PER_EVENT = 13  # scan: read t + mask byte, write start + delay
OPS_PER_QUEUED_EVENT = 6  # stt*rank, t - p, max, f + p, start - t, sum
POLICY = {"opt_state": "cxl_pool2", "grad": "cxl_pool1"}
# the shared fabric: the paper's KV-cache pooling scenario at qwen3-0.6b's widths
FABRIC_HOSTS = 8
FABRIC_LOAD = dict(kind="decode", batch=64, seq=1, cache_len=4096)
FABRIC_EVENTS_PER_ACCESS = 8192
# the wide fabric: more hosts than the route word holds stages, cut in depth
WIDE_HOSTS = 32
WIDE_LOAD = dict(kind="decode", batch=8, seq=1, cache_len=1024)
WIDE_EVENTS_PER_ACCESS = 256
FABRIC_POLICY = {"kvcache": "shared_pool"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float) -> tuple:
    """The least time for one call: bytes moved once over the HBM rate, or
    the f32 operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * MS_PER_S
    t_ops = ops / F32_OPS_PER_S * MS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cascade_bound(t, bits, n_stages, bytes_per_event, out_per_row):
    """Bound of one cascade call on these inputs: the events the stages
    queue here decide the operations."""
    nbytes = bytes_per_event * t.numel() + 4 * (n_stages + t.shape[0] * out_per_row)
    queued = sum(int(((bits >> s) & 1).sum()) for s in range(n_stages))
    return bound_ms(nbytes, OPS_PER_QUEUED_EVENT * queued)


def synthetic_times(rows: int, n: int, seed: int, dev):
    """Sorted uniform (even rows) and bursty (odd rows) arrival times at a
    density that queues at every stage."""
    rng = np.random.default_rng(seed)
    span = 3.0 * n  # ns: ~3 ns between arrivals
    t = np.empty((rows, n), np.float32)
    for r in range(rows):
        if r % 2 == 0:
            x = rng.uniform(0, span, n)
        else:
            centers = rng.uniform(0, span, max(1, n // 64))
            x = rng.choice(centers, size=n) + rng.exponential(20.0, size=n)
        t[r] = np.sort(x)
    return torch.from_numpy(t).to(dev), rng


def synthetic_inputs(rows: int, n: int, n_stages: int, seed: int, dev):
    """Synthetic times and random route words."""
    t, rng = synthetic_times(rows, n, seed, dev)
    bits = rng.integers(0, 1 << n_stages, (rows, n)).astype(np.int32)
    return t, torch.from_numpy(bits).to(dev)


def fabric_inputs(flat, rows: int, n: int, seed: int, dev):
    """Synthetic times on a multi-host fabric: each event a random virtual
    (host, pool) pair, with that pair's route word and host id."""
    t, rng = synthetic_times(rows, n, seed, dev)
    bits_pool, _, order = plan_cascade(flat)
    vp = rng.integers(0, flat.route.shape[0], (rows, n))
    bits = torch.from_numpy(bits_pool[vp].astype(np.int32)).to(dev)
    hosts = torch.from_numpy((vp // flat.n_pools).astype(np.int32)).to(dev)
    stts = torch.tensor(flat.switch_stt_ns[list(order)], dtype=torch.float32, device=dev)
    return t, bits, hosts, stts


def compare(name, t, bits, stts, reps=20):
    """Cascade kernel vs plain on the same CUDA inputs."""
    tk, ik, pk = kcong.congestion_cascade(t, bits, stts)
    tp, ip, pp = kref.serial_queue_cascade(t, bits, stts)
    torch.cuda.synchronize()
    check(torch.equal(ik, ip), f"{name}: slot_idx differs from the plain version")
    torch.testing.assert_close(tk, tp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0.0)
    check(bool(torch.isfinite(pk).all()), f"{name}: non-finite delays")
    err = float((tk - tp).abs().max())
    ms = median_ms(lambda: kcong.congestion_cascade(t, bits, stts), reps)
    plain_ms = median_ms(lambda: kref.serial_queue_cascade(t, bits, stts), max(3, reps // 4))
    n_stages = int(stts.shape[0])
    bms, by = cascade_bound(t, bits, n_stages, BYTES_PER_EVENT, n_stages)
    row = dict(shape=list(t.shape), stages=n_stages, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
               delay_ns=[float(x) for x in pk.sum(0)])
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def compare_hosts(name, t, bits, hosts, stts, n_hosts, reps=20):
    """Host-segmented cascade kernel vs plain, and vs the single-host
    kernel's per-stage totals, on the same CUDA inputs."""
    tk, ik, pk = kcong.congestion_cascade_hosts(t, bits, hosts, stts, n_hosts)
    tp, ip, pp = kref.serial_queue_cascade(t, bits, stts, hosts=hosts, n_hosts=n_hosts)
    _, i1, p1 = kcong.congestion_cascade(t, bits, stts)
    torch.cuda.synchronize()
    check(torch.equal(ik, ip), f"{name}: slot_idx differs from the plain version")
    check(torch.equal(ik, i1), f"{name}: slot_idx differs from the single-host kernel")
    torch.testing.assert_close(tk, tp, rtol=1e-6, atol=0.0)
    # per-host sums: double atomics in a run-dependent order (kernel) and an
    # f64 scatter-add (plain), both rounded to f32
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(pk.sum(-1), p1, rtol=1e-6, atol=0.0)
    check(bool(torch.isfinite(pk).all()), f"{name}: non-finite delays")
    err = float((tk - tp).abs().max())
    ms = median_ms(lambda: kcong.congestion_cascade_hosts(t, bits, hosts, stts, n_hosts), reps)
    plain_ms = median_ms(
        lambda: kref.serial_queue_cascade(t, bits, stts, hosts=hosts, n_hosts=n_hosts),
        max(3, reps // 4),
    )
    n_stages = int(stts.shape[0])
    bms, by = cascade_bound(t, bits, n_stages, HOSTS_BYTES_PER_EVENT, n_stages * n_hosts)
    row = dict(shape=list(t.shape), stages=n_stages, hosts=n_hosts, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
               psd_max_rel_err=float(((pk - pp).abs() / pp.abs().clamp(min=1e-30)).max()),
               delay_ns_per_host=[float(x) for x in pk.sum((0, 1))])
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def compare_scan(name, t, mask, stt, reps=20):
    """Scan kernel vs plain on the same CUDA inputs."""
    sk, dk = kcong.congestion_scan(t, mask, stt)
    sp, dp = kref.congestion_scan(t, mask, stt)
    torch.cuda.synchronize()
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0.0)
    check(bool(torch.isfinite(dk).all()), f"{name}: non-finite delays")
    err = max(float((sk - sp).abs().max()), float((dk - dp).abs().max()))
    ms = median_ms(lambda: kcong.congestion_scan(t, mask, stt), reps)
    plain_ms = median_ms(lambda: kref.congestion_scan(t, mask, stt), max(3, reps // 4))
    masked = int(mask.sum())
    bms, by = bound_ms(SCAN_BYTES_PER_EVENT * t.numel(), OPS_PER_QUEUED_EVENT * masked)
    row = dict(shape=list(t.shape), masked=masked, stt=stt, ms=ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, max_abs_err=err, delay_ns=float(dk.sum()))
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def staged_batch(traces, flat, dev):
    """A batch's cascade inputs, staged exactly as the analyzer stages them
    (time-sorted rows, pads at finfo.max/4 with no route), with each
    event's virtual pool and host."""
    n_bucket = bucket_pow2(max(tr.n for tr in traces))
    b_bucket = bucket_pow2(len(traces), floor=1)
    buf = EventStager(np.float32).stage(traces, b_bucket, n_bucket)
    valid = torch.from_numpy(buf["valid"]).to(dev)
    pool = torch.from_numpy(buf["pool"]).to(dev).long()
    hosts = torch.from_numpy(buf["host"]).to(dev)
    vp = hosts.long() * flat.n_pools + pool
    big = torch.finfo(torch.float32).max / 4
    t_cur = torch.where(valid, torch.from_numpy(buf["t"]).to(dev), big).contiguous()
    out = dict(t=t_cur, hosts=hosts.contiguous(), vp=vp, valid=valid)
    if flat.n_switches <= kcong.MAX_STAGES:
        bits_pool, _, order = plan_cascade(flat)
        out["bits"] = torch.where(valid, torch.from_numpy(bits_pool).to(dev)[vp], 0).contiguous()
        out["stts"] = torch.tensor(flat.switch_stt_ns[list(order)], dtype=torch.float32,
                                   device=dev)
    return out


def oracle(flat, traces, n_windows=128, bw_window_ns=10_000.0):
    """analyze_ref (f64) over the epochs, each with the analyzer's
    effective span-scaled window; summed totals and per-host arrays."""
    tot = None
    for tr in traces:
        span = max(float(tr.t_ns.max()) + 1.0, bw_window_ns)
        bd = analyze_ref(flat, tr, bw_window_ns=max(span / n_windows, 1.0),
                         n_windows=n_windows)
        tot = bd if tot is None else tot + bd
    return tot


def check_totals(tag, got, want, steps):
    """Report totals (s) against the oracle's per-step totals (ns) times
    the steps, at the fused cascade's bar."""
    tol = {"latency_s": (1e-4, 1e-3), "congestion_s": (1e-3, 1e-2),
           "bandwidth_s": (1e-2, 1.0)}
    ref = {"latency_s": want.latency_ns, "congestion_s": want.congestion_ns,
           "bandwidth_s": want.bandwidth_ns}
    for k, (rel, absol) in tol.items():
        g, w = s_to_ns(getattr(got, k)), steps * ref[k]
        check(np.isfinite(g), f"{tag} {k} is not finite")
        check(abs(g - w) <= max(rel * abs(w), absol),
              f"{tag} {k}: {g} ns vs analyze_ref {w} ns")
        print(f"[{tag}] {k}: {g!r} ns, analyze_ref {w!r} ns, "
              f"rel err {abs(g - w) / max(abs(w), 1e-30):.3e}")


def fabric_session(n_hosts, load, events_per_access, dev):
    """n_hosts trace-only qwen3-0.6b tenants pooling their KV caches."""
    tenants = []
    for h in range(n_hosts):
        regions, phases = build_regions_and_phases(CONFIG, **load)
        tenants.append(Tenant(f"tenant{h}", phases, regions, ClassMapPolicy(FABRIC_POLICY)))
    return FabricSession(
        pooled_topology(n_hosts=n_hosts), tenants, epoch=EpochSchedule("layer"),
        hw=H100_SXM, coherency=CoherencyConfig(shared_classes=("kvcache",)),
        max_events_per_access=events_per_access, device=dev,
    )


def timed_merges(sess):
    """Record the host seconds of each of the session's merged rounds."""
    inner = sess._merged_round
    seconds = []

    def merged_round():
        t0 = time.perf_counter()
        out = inner()
        seconds.append(time.perf_counter() - t0)
        return out

    sess._merged_round = merged_round
    return seconds


def reset_counts():
    kcong.launches = kcong.hosts_launches = kcong.scan_launches = 0
    kops.plain_launches = 0


def counts():
    return dict(cascade=kcong.launches, hosts=kcong.hosts_launches,
                scan=kcong.scan_launches, plain=kops.plain_launches)


def profile_batch(tag, an, traces):
    """Host staging on the host clock, then one analyze_batch under
    torch.profiler."""
    stager = EventStager(np.float32)
    shape = (bucket_pow2(len(traces), floor=1), bucket_pow2(max(tr.n for tr in traces)))
    stager.stage(traces, *shape)  # first call allocates the planes
    t0 = time.perf_counter()
    stager.stage(traces, *shape)
    print(f"[{tag}] host staging {time.perf_counter() - t0:.6f} s per batch {list(shape)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        an.analyze_batch(traces)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    print(f"[{tag}] analyze_batch {batch_s:.6f} s under the profiler")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=12))


def slice1_main_path(dev):
    """Phase 4: the attached qwen3-0.6b training step on figure1."""
    regions, phases = build_regions_and_phases(CONFIG, "train", batch=8, seq=4096)
    sim = CXLMemSim(
        figure1_topology(), ClassMapPolicy(POLICY), epoch=EpochSchedule("layer"),
        hw=H100_SXM, max_events_per_access=1024, check_capacity=False, device="cuda",
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    d, f, bf16 = CONFIG.d_model, CONFIG.d_ff, torch.bfloat16
    weights = [
        (
            torch.randn(d, f, generator=gen, device=dev, dtype=bf16) * d ** -0.5,
            torch.randn(d, f, generator=gen, device=dev, dtype=bf16) * d ** -0.5,
            torch.randn(f, d, generator=gen, device=dev, dtype=bf16) * f ** -0.5,
        )
        for _ in range(CONFIG.n_layers)
    ]
    x = torch.randn(8 * 4096, d, generator=gen, device=dev, dtype=bf16)

    def step(h):
        # stand-in for the model: the config's SwiGLU MLP products, bf16
        for wi, wu, wo in weights:
            h = h + (torch.nn.functional.silu(h @ wi) * (h @ wu)) @ wo
        return h

    prog = sim.attach(step, phases, regions)
    traces = prog.epoch_traces()
    n_max = max(tr.n for tr in traces)
    print(f"[main] {len(traces)} epochs, up to {n_max} events, "
          f"{sum(tr.n for tr in traces)} events per step")
    b = staged_batch(traces, prog.sim.flat, dev)
    main_row = compare("main_batch", b["t"], b["bits"], b["stts"])

    # one warm-up step takes the first-use costs (staging planes, caching
    # allocator, GEMM setup) out of the 3 measured steps
    prog.step(x)
    warm_analyzer_s, warm_native_s = prog.report.analyzer_s, prog.report.native_s
    reset_counts()
    rep = prog.run(3, x)
    c = counts()
    check(c["cascade"] == 3, f"kernel launched {c['cascade']} times in 3 steps, want 3")
    check(c["plain"] == 0, f"plain cascade ran {c['plain']} times on the card")
    check(c["hosts"] == 0 and c["scan"] == 0, f"fabric kernels ran on one host: {c}")

    check_totals("main", rep, oracle(prog.sim.flat, traces), rep.steps)
    # both switches queue; the RC cannot: every event through it has just
    # left switch0, spaced >= 2 ns apart, and the RC's STT is 0.5 ns
    names = prog.sim.flat.switch_names
    psc = dict(zip(names, rep.per_switch_congestion_ns.tolist()))
    check(psc["switch0"] > 0 and psc["switch1"] > 0, f"a switch never queued: {psc}")
    print(f"[main] per-switch congestion ns {json.dumps(psc)}")
    print(f"[main] summary {json.dumps(rep.summary())}")
    print(f"[main] analyzer {(rep.analyzer_s - warm_analyzer_s) / 3:.6f} s/step and "
          f"native {(rep.native_s - warm_native_s) / 3:.6f} s/step over the 3 "
          f"measured steps; warm-up step analyzer {warm_analyzer_s:.6f} s, "
          f"native {warm_native_s:.6f} s")
    profile_batch("profile", prog._analyzer, traces)
    return main_row, c["cascade"]


def fabric_main_path(dev):
    """Phase 5: the 8-tenant KV-pooling fabric through FabricSession."""
    t0 = time.perf_counter()
    sess = fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda")
    merge_s = timed_merges(sess)
    check(sess._analyzer.fused, "the 8-host fabric must run the fused cascade")
    print(f"[fabric] {sess.flat.n_switches} stages "
          f"({', '.join(sess.flat.switch_names)}), session set-up "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sess.round()  # warm-up: tracing, merging, first-use costs
    warm = sess.report
    warm_s, warm_analyzer_s = time.perf_counter() - t0, warm.analyzer_s
    merged = sess._round_cache[0]
    n_max = max(tr.n for tr in merged)
    print(f"[fabric] {len(merged)} merged epochs, up to {n_max} events, "
          f"{sum(tr.n for tr in merged)} events per round; warm-up round {warm_s:.3f} s "
          f"(merge {merge_s[0]:.3f} s, analyzer {warm_analyzer_s:.6f} s)")

    reset_counts()
    rep = sess.run(3)
    c = counts()
    check(c["hosts"] == 3, f"hosts kernel launched {c['hosts']} times in 3 rounds, want 3")
    check(c["plain"] == 0 and c["cascade"] == 0 and c["scan"] == 0,
          f"other cascades ran on the fabric path: {c}")
    check(rep.rounds == 4 and rep.bi_messages > 0, f"rounds {rep.rounds}, BI {rep.bi_messages}")

    flat = sess.flat
    ref = oracle(flat, merged)
    check_totals("fabric", rep, ref, rep.rounds)
    lat_h = np.array([s_to_ns(h.latency_s) for h in rep.hosts])
    cong_h = np.array([s_to_ns(h.congestion_s) for h in rep.hosts])
    bw_h = np.array([s_to_ns(h.bandwidth_s) for h in rep.hosts])
    np.testing.assert_allclose(lat_h, rep.rounds * ref.per_host_latency_ns, rtol=1e-4)
    np.testing.assert_allclose(cong_h, rep.rounds * ref.per_host_congestion_ns, rtol=5e-3)
    for name, per_host, total in (("latency", lat_h, rep.latency_s),
                                  ("congestion", cong_h, rep.congestion_s),
                                  ("bandwidth", bw_h, rep.bandwidth_s)):
        check(abs(per_host.sum() - s_to_ns(total)) <= max(1e-4 * s_to_ns(total), 1e-2),
              f"per-host {name} {per_host.sum()} ns does not close on {s_to_ns(total)} ns")
    psc = dict(zip(flat.switch_names, rep.per_switch_congestion_ns.tolist()))
    check(psc["fabric_sw"] > 0, f"the shared switch never queued: {psc}")
    print(f"[fabric] per-host latency ns {lat_h.tolist()}")
    print(f"[fabric] per-host congestion ns {cong_h.tolist()}, analyze_ref "
          f"{(rep.rounds * ref.per_host_congestion_ns).tolist()}")
    print(f"[fabric] per-switch congestion ns {json.dumps(psc)}")
    print(f"[fabric] bi_messages {rep.bi_messages!r}, coherency {rep.coherency_s!r} s")
    print(f"[fabric] summary {json.dumps(rep.summary())}")
    print(f"[fabric] analyzer {(rep.analyzer_s - warm_analyzer_s) / 3:.6f} s/round over "
          f"the 3 measured rounds; merge (replayed) "
          f"{float(np.mean(merge_s[1:])):.6f} s/round")

    b = staged_batch(merged, flat, dev)
    row = compare_hosts("fabric_batch", b["t"], b["bits"], b["hosts"], b["stts"],
                        flat.n_hosts)
    profile_batch("fabric-profile", sess._analyzer, merged)
    return row, c["hosts"]


def wide_fabric_path(dev):
    """Phase 6: 32 hosts, 33 stages: the unfused per-stage loop."""
    t0 = time.perf_counter()
    sess = fabric_session(WIDE_HOSTS, WIDE_LOAD, WIDE_EVENTS_PER_ACCESS, "cuda")
    merge_s = timed_merges(sess)
    check(not sess._analyzer.fused, "the 32-host fabric must fall back to the unfused loop")
    stages = sess.flat.n_switches
    print(f"[wide] {stages} stages, session set-up {time.perf_counter() - t0:.3f} s")
    reset_counts()
    t0 = time.perf_counter()
    rep = sess.run(2)
    wall = time.perf_counter() - t0
    c = counts()
    merged = sess._round_cache[0]
    print(f"[wide] {len(merged)} merged epochs, up to {max(tr.n for tr in merged)} "
          f"events, {sum(tr.n for tr in merged)} per round; merge {merge_s[0]:.3f} s "
          f"(first round)")
    check(c["scan"] == stages * 2,
          f"scan launched {c['scan']} times in 2 rounds of {stages} stages")
    check(c["plain"] == 0 and c["cascade"] == 0 and c["hosts"] == 0,
          f"other kernels ran on the wide path: {c}")
    flat = sess.flat
    ref = oracle(flat, merged)
    for k, rel, absol in (("latency", 1e-4, 1e-3), ("congestion", 1e-3, 1e-3)):
        g = s_to_ns(getattr(rep, f"{k}_s"))
        w = rep.rounds * getattr(ref, f"{k}_ns")
        check(abs(g - w) <= max(rel * abs(w), absol), f"wide {k}: {g} ns vs {w} ns")
        print(f"[wide] {k}: {g!r} ns, analyze_ref {w!r} ns, "
              f"rel err {abs(g - w) / max(abs(w), 1e-30):.3e}")
    check(rep.congestion_s > 0 and len(rep.hosts) == WIDE_HOSTS, "wide fabric never queued")
    print(f"[wide] analyzer {rep.analyzer_s / 2:.6f} s/round, 2 rounds in {wall:.3f} s")

    b = staged_batch(merged, flat, dev)
    s0 = int(flat.stage_order()[0])
    routed = torch.from_numpy(flat.route[:, s0] > 0).to(dev)
    mask = (routed[b["vp"]] & b["valid"]).contiguous()
    row = compare_scan(f"wide_stage_{flat.switch_names[s0]}", b["t"], mask,
                       float(np.float32(flat.switch_stt_ns[s0])))
    return row, c["scan"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # full f32 matrix products everywhere (stated, not left to defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment ----------------------------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {smi}")

    # -- 2. build, one nvcc per source, all at once ------------------------- #
    for name, res in kcong.build_all().items():
        print(f"[build] {name}: {res.path.relative_to(ROOT)} in {res.seconds:.3f} s")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")

    # -- 3. kernels vs plain at synthetic shapes ---------------------------- #
    fig = figure1_topology().flatten()
    chain = chained_topology(8).flatten()
    rows = []
    for name, (b, n), stts_np, seed in (
        ("ragged", (4, 3000), np.asarray([4.0, 2.0, 0.5]), 1),
        ("figure1", (32, 131072), fig.switch_stt_ns[list(plan_cascade(fig)[2])], 2),
        ("chain8", (8, 65536), chain.switch_stt_ns[list(plan_cascade(chain)[2])], 3),
    ):
        stts = torch.tensor(stts_np, dtype=torch.float32, device=dev)
        t, bits = synthetic_inputs(b, n, int(stts.shape[0]), seed, dev)
        rows.append(compare(name, t, bits, stts))
    topo = figure1_topology()
    fig3 = Topology(topo.pools, topo.switches, topo.rc_latency_ns, topo.rc_bandwidth_gbps,
                    topo.rc_stt_ns, topo.local_dram_latency_ns, n_hosts=3).flatten()
    host_rows = []
    for name, flat, (b, n), seed in (
        ("hosts_ragged_figure1x3", fig3, (4, 3000), 4),
        ("hosts_pooled8", pooled_topology(n_hosts=8).flatten(), (32, 131072), 5),
    ):
        t, bits, hosts, stts = fabric_inputs(flat, b, n, seed, dev)
        host_rows.append(compare_hosts(name, t, bits, hosts, stts, flat.n_hosts))
    t, rng = synthetic_times(32, 131072, 6, dev)
    mask = torch.from_numpy(rng.random((32, 131072)) < 0.5).to(dev)
    scan_rows = [compare_scan("scan_random_mask", t, mask, 2.0)]

    # -- 4-6. the main paths ------------------------------------------------ #
    main_row, cascade_launches = slice1_main_path(dev)
    fabric_row, hosts_launches = fabric_main_path(dev)
    wide_row, scan_launches = wide_fabric_path(dev)
    host_rows.append(fabric_row)
    scan_rows.append(wide_row)

    # -- 7. the kernels line and the result --------------------------------- #
    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, source, replaces, launches, comps, row in (
        ("congestion_cascade", "congestion_cascade.cu", "congestion.py:290",
         cascade_launches, rows + [main_row], main_row),
        ("congestion_cascade_hosts", "congestion_cascade.cu", "congestion.py:350",
         hosts_launches, host_rows, fabric_row),
        ("congestion_scan", "congestion_scan.cu", "congestion.py:113",
         scan_launches, scan_rows, wide_row),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in comps),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    print(f"[done] chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
