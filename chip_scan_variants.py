#!/usr/bin/env python3
"""Time the scan kernel (``congestion_scan.cu``) beside variants of its
design on one NVIDIA card.

Run from the repository root:  python3 chip_scan_variants.py

Each variant is the committed source with one piece of the design undone,
by text substitution (the script fails if a substitution no longer
applies), built with the kernels' own nvcc flags:

- ``kernel``: the source as committed;
- ``acquire_release``: the status words written with release stores and
  polled with acquire loads instead of relaxed ones;
- ``tile_4096``: 16 events a thread (tiles of 4096) instead of 32;
- ``direct_loads``: each thread loads and stores its own consecutive
  16-byte vectors, with no staging through shared memory;
- ``no_look_back``: the look-back left out (every tile's prefixes are the
  identity): the result is wrong, and the time is what the rest costs.

Every variant but the last must equal the plain version bitwise on each
case.  Times are on the card (calls back to back behind a sleep kernel,
between two CUDA events; each call includes the launch's zeroing of the
status words), in turns: every variant once in order, then once in
reverse.  Prints the card's name and power limit, then one JSON line per
variant and case.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

SOURCE = kbuild.SOURCES["congestion_scan"]
OUT = kbuild.BUILD_DIR / "scan_variants"
SCAN_BYTES_PER_EVENT = 13  # read t + mask byte, write start + delay
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SLEEP_CYCLES = 100_000_000
SUBSTITUTIONS = {  # variant: [(old, new), ...] on the committed source
    "kernel": [],
    "acquire_release": [
        ('"st.relaxed.gpu.global.u64', '"st.release.gpu.global.u64'),
        ('"ld.relaxed.gpu.global.u64', '"ld.acquire.gpu.global.u64'),
    ],
    "tile_4096": [("constexpr int kItems = 32;", "constexpr int kItems = 16;")],
    "direct_loads": [
        ("raw[j] = t4[32 * j + lane];",
         "raw[j] = reinterpret_cast<const float4*>(t_in + off)[j];"),
        ("for (int j = 0; j < kVec; ++j) buf[swizzle(32 * j + lane)] = raw[j];", ""),
        ("const float4 v = buf[swizzle(lane * kVec + j)];", "const float4 v = raw[j];"),
        ("d4[32 * j + lane] = buf[swizzle(32 * j + lane)];",
         "d4[lane * kVec + j] = buf[swizzle(lane * kVec + j)];"),
    ],
    "no_look_back": [("      prefix = look_back<V>(status, tile, first);\n", "")],
}
TILES = {"tile_4096": 4096}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in SUBSTITUTIONS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {src.count(old)} times in {SOURCE}")
        src = src.replace(old, new)
    return src


def build(name: str):
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(variant_source(name))
    so = OUT / f"{name}.so"
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.congestion_scan_launch.argtypes = [p, p, ctypes.c_float, p, p, p, i64, i64, i64, p]
    lib.congestion_scan_launch.restype = ctypes.c_int
    return lib, regs


def scan(lib, tile, t, mask, stt):
    rows, n = t.shape
    start, delay = torch.empty((2, rows, n), dtype=t.dtype, device=t.device)
    status = torch.empty(2 * rows * -(-n // tile) + 1, dtype=torch.int64, device=t.device)
    rc = lib.congestion_scan_launch(t.data_ptr(), mask.data_ptr(), stt, start.data_ptr(),
                                    delay.data_ptr(), status.data_ptr(), status.numel(), rows, n,
                                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return start, delay


def device_ms(fn, reps: int = 40) -> float:
    """Time on the card of one call: the calls run back to back behind a
    sleep kernel that holds the stream while the host enqueues them."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    for _ in range(reps):
        fn()
    ev[2].record()
    ev[2].synchronize()
    return ev[1].elapsed_time(ev[2]) / reps


def inputs(rows: int, n: int, seed: int, dev):
    """Sorted uniform times at about 3 ns apart, half the events masked."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 3.0 * n, (rows, n)), axis=1).astype(np.float32)
    mask = rng.random((rows, n)) < 0.5
    return torch.from_numpy(t).to(dev), torch.from_numpy(mask).to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_scan_variants: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}")
    with concurrent.futures.ThreadPoolExecutor(len(SUBSTITUTIONS)) as pool:
        futures = {name: pool.submit(build, name) for name in SUBSTITUTIONS}
        libs = {}
        for name, f in futures.items():
            libs[name], regs = f.result()
            print(f"[build] {name}: {regs}")
    dev = torch.device("cuda")
    cases = {"wide_32x524288": inputs(32, 524288, 1, dev),
             "one_row_1x1048576": inputs(1, 1 << 20, 2, dev),
             "rows_32x131072": inputs(32, 131072, 3, dev),
             "ragged_8x131071": inputs(8, 131071, 4, dev)}
    for case, (t, mask) in cases.items():
        want = kref.congestion_scan(t, mask, 2.0)
        for name, lib in libs.items():
            got = scan(lib, TILES.get(name, kref.SCAN_TILE), t, mask, 2.0)
            equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            if name != "no_look_back" and not equal:
                raise RuntimeError(f"{name} differs from the plain version on {case}")
    times = {}
    order = list(libs)
    for names in (order, order[::-1]):
        for name in names:
            for case, (t, mask) in cases.items():
                lib, tile = libs[name], TILES.get(name, kref.SCAN_TILE)
                times.setdefault((name, case), []).append(
                    device_ms(lambda: scan(lib, tile, t, mask, 2.0)))
    for case, (t, mask) in cases.items():
        nbytes = SCAN_BYTES_PER_EVENT * t.numel()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for name in order:
            ms = float(np.mean(times[(name, case)]))
            print(json.dumps(dict(variant=name, case=case, shape=list(t.shape),
                                  device_ms=times[(name, case)], mean_ms=ms, bound_ms=bound,
                                  bound_share=bound / ms, gb_per_s=nbytes / ms / 1e6)))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
