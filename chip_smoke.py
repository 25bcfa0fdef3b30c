#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the congestion cascade kernel, compiled by nvcc from the
   repository's sources into build/repro_torch_kernels/;
3. kernel vs plain: the kernel against its plain PyTorch version on the same
   CUDA inputs at three shapes ([4, 3000] S=3, [32, 131072] with figure1's
   stages, [8, 65536] with chained_topology(8)'s nine stages) and on the main
   path's own batch: slot indices exactly equal, final times to rtol 1e-6,
   per-stage delays to rtol 1e-5; median times over CUDA events;
4. main path: CXLMemSim attached to a bf16 stand-in step on the card, with
   the qwen3-0.6b published config's layer-epoch trace (8 x 4096 tokens)
   on the paper's Figure 1 topology, one warm-up step, then 3 measured
   steps; over those 3 the kernel's launch count must
   rise by exactly 3 and the plain path's by 0, the report's delay totals
   must match the f64 oracle ``analyze_ref``, and both switches must queue;
   then where one analyzer batch spends its time: host staging on the host
   clock, and a torch.profiler table of the rest;
5. a JSON ``kernels`` line, then the card's nvidia-smi line, then the result
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
    CXLMemSim,
    EpochSchedule,
    EventStager,
    analyze_ref,
    bucket_pow2,
    chained_topology,
    figure1_topology,
    plan_cascade,
)
from repro_torch.core.units import s_to_ns  # noqa: E402
from repro_torch.kernels import congestion as kcong  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import build_regions_and_phases  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
MS_PER_S = 1e3
BYTES_PER_EVENT = 16  # read t + route bits, write t_final + slot_idx
OPS_PER_QUEUED_EVENT = 6  # stt*rank, t - p, max, f + p, start - t, sum
POLICY = {"opt_state": "cxl_pool2", "grad": "cxl_pool1"}


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


def bound_ms(t: torch.Tensor, bits: torch.Tensor, n_stages: int) -> tuple:
    """The least time for one cascade call on these inputs: bytes moved once
    over the HBM rate, or the f32 operations the queued events need over
    the f32 rate, whichever is larger."""
    n_events = t.numel()
    nbytes = BYTES_PER_EVENT * n_events + 4 * (n_stages + t.shape[0] * n_stages)
    queued = sum(int(((bits >> s) & 1).sum()) for s in range(n_stages))
    t_bytes = nbytes / HBM_BYTES_PER_S * MS_PER_S
    t_ops = OPS_PER_QUEUED_EVENT * queued / F32_OPS_PER_S * MS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_inputs(rows: int, n: int, n_stages: int, seed: int, dev):
    """Sorted uniform (even rows) and bursty (odd rows) arrival times at a
    density that queues at every stage, and random route words."""
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
    bits = rng.integers(0, 1 << n_stages, (rows, n)).astype(np.int32)
    return torch.from_numpy(t).to(dev), torch.from_numpy(bits).to(dev)


def compare(name, t, bits, stts, reps=20):
    """Kernel vs plain on the same CUDA inputs; returns the measurements."""
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
    bms, by = bound_ms(t, bits, int(stts.shape[0]))
    row = dict(shape=list(t.shape), stages=int(stts.shape[0]), ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
               delay_ns=[float(x) for x in pk.sum(0)])
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def staged_main_batch(traces, flat, dev):
    """The main path's cascade inputs, staged exactly as the analyzer
    stages them (time-sorted rows, pads at finfo.max/4 with no route)."""
    n_bucket = bucket_pow2(max(tr.n for tr in traces))
    b_bucket = bucket_pow2(len(traces), floor=1)
    buf = EventStager(np.float32).stage(traces, b_bucket, n_bucket)
    bits_pool, _, order = plan_cascade(flat)
    valid = torch.from_numpy(buf["valid"]).to(dev)
    t = torch.from_numpy(buf["t"]).to(dev)
    pool = torch.from_numpy(buf["pool"]).to(dev).long()
    big = torch.finfo(torch.float32).max / 4
    t_cur = torch.where(valid, t, big).contiguous()
    bits = torch.where(valid, torch.from_numpy(bits_pool).to(dev)[pool], 0).contiguous()
    stts = torch.tensor(flat.switch_stt_ns[list(order)], dtype=torch.float32, device=dev)
    return t_cur, bits, stts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
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

    # -- 2. build ----------------------------------------------------------- #
    res = kcong.build()
    print(f"[build] {res.path.relative_to(ROOT)} in {res.seconds:.3f} s")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

    # -- 3. kernel vs plain at three shapes --------------------------------- #
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

    # -- 4. the main path --------------------------------------------------- #
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
    t_main, bits_main, stts_main = staged_main_batch(traces, prog.sim.flat, dev)
    main_row = compare("main_batch", t_main, bits_main, stts_main)

    # one warm-up step takes the first-use costs (staging planes, caching
    # allocator, GEMM setup) out of the 3 measured steps
    prog.step(x)
    warm_analyzer_s, warm_native_s = prog.report.analyzer_s, prog.report.native_s
    kcong.launches = 0
    kops.plain_launches = 0
    rep = prog.run(3, x)
    launches, plain = kcong.launches, kops.plain_launches
    check(launches == 3, f"kernel launched {launches} times in 3 steps, want 3")
    check(plain == 0, f"plain cascade ran {plain} times on the card")

    steps = rep.steps  # the warm-up step and the 3 measured ones
    ref_lat = ref_cong = ref_bw = 0.0
    for tr in traces:
        span = max(float(tr.t_ns.max()) + 1.0, 10_000.0)
        bd = analyze_ref(prog.sim.flat, tr, bw_window_ns=max(span / 128, 1.0),
                         n_windows=128)
        ref_lat += bd.latency_ns
        ref_cong += bd.congestion_ns
        ref_bw += bd.bandwidth_ns
    got = {k: s_to_ns(getattr(rep, k)) for k in ("latency_s", "congestion_s", "bandwidth_s")}
    want = {"latency_s": steps * ref_lat, "congestion_s": steps * ref_cong,
            "bandwidth_s": steps * ref_bw}
    tol = {"latency_s": (1e-4, 1e-3), "congestion_s": (1e-3, 1e-2),
           "bandwidth_s": (1e-2, 1.0)}
    for k, (rel, absol) in tol.items():
        check(np.isfinite(got[k]), f"{k} is not finite")
        check(abs(got[k] - want[k]) <= max(rel * abs(want[k]), absol),
              f"{k}: {got[k]} ns vs analyze_ref {want[k]} ns")
        print(f"[main] {k}: {got[k]!r} ns, analyze_ref {want[k]!r} ns, "
              f"rel err {abs(got[k] - want[k]) / max(abs(want[k]), 1e-30):.3e}")
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

    # where one batch's analyzer time goes: host staging (numpy fills and
    # sorts, not seen by the profiler), then the profiled tensor work
    stager = EventStager(np.float32)
    stager.stage(traces, *t_main.shape)  # first call allocates the planes
    t0 = time.perf_counter()
    stager.stage(traces, *t_main.shape)
    print(f"[profile] host staging {time.perf_counter() - t0:.6f} s per batch")
    an = prog._analyzer
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        an.analyze_batch(traces)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    print(f"[profile] analyze_batch {batch_s:.6f} s under the profiler")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=12))

    # -- 5. the kernels line and the result --------------------------------- #
    kernels = [{
        "name": "congestion_cascade",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/congestion_cascade.cu",
        "replaces": "src/repro/kernels/congestion.py:290",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows + [main_row]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]
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
