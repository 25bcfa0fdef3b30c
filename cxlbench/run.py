"""Run one cell of the benchmark once and print its result line.

    python3 -m cxlbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``cxlbench/configs/<config>.json``, its traffic mix
``cxlbench/traffic/<traffic>.json`` (whose ``kind`` names the driver
``cxlbench/drivers/<kind>.py``), its limits ``cxlbench/limits/<cell>.json``
and each per-layer metric's reader ``cxlbench/metrics/<metric>.py``.

A run: set-up (inputs from the seed, the program, one warm-up unit, which
builds every kernel), then units back to back for ``--seconds`` (the last
one finishing, and any asynchronous analysis flushed, inside the window),
then the check against the plain reference.  The run's threads are
pinned to fixed cores local to the card (``host.Pinning``), and an
earlier line of standard error records the card's clocks and what the
host did over the window.  ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` runs the window under
``torch.profiler`` and reports its per-layer metrics.  The last line of
standard output is the result as JSON; the last lines of standard error
give each number compared beside its limit.  Without a card, or with
fewer cards than the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import host  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
HOST_THREADS = 4


def _fixed_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one process, a few host threads: steadier host-bound cells
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(name: str, bench: dict = None, base: Path = HERE) -> dict:
    """A cell's entry, configuration, traffic mix, limits and per-layer
    metrics, each found by name under ``base``."""
    bench = bench or spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"cxlbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {
        "cell": cell,
        "config": load_json(base / "configs" / f"{cell['config']}.json"),
        "traffic": load_json(base / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(base / "limits" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": layers,
    }


def driver_module(kind: str):
    return importlib.import_module(f"cxlbench.drivers.{kind}")


def metric_reader(name: str):
    """The reader ``metrics/<name>.py``, or, for a quantity split by the
    end-to-end metric it moves (``idle_share.pool8``), the quantity's one
    reader ``metrics/<quantity>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    sp = importlib.util.spec_from_file_location(f"cxlbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run_cell(r: dict, seed: int, seconds: float, trace: bool, device, *, driver=None,
             units: int = 0, pin: host.Pinning = None) -> dict:
    """One run of a resolved cell on ``device``; returns the result dict
    (``correct`` and the rest), or raises.  ``driver`` puts another class
    in the traffic kind's ``Driver``'s place (a control); ``units`` ends
    the window after that many units rather than after ``seconds``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import profiling

    cuda = torch.device(device).type == "cuda"
    drv_cls = driver or driver_module(r["traffic"]["kind"]).Driver
    drv = drv_cls(r["config"], r["traffic"], seed, device)
    drv.warmup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - PROCESS_START
    host_info = {"pinned": pin.settle() if pin is not None else {}}
    if cuda:
        host_info["card_before"] = host.card()
    window = host.Window()
    window.open()

    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    done = 0
    while True:
        drv.step()
        done += 1
        if (done >= units) if units else (time.perf_counter() - t0 >= seconds):
            break
    drv.finish()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    host_info.update(window.close())
    if cuda:
        host_info["card_after"] = host.card()
    host_info["probe_ms_after"] = host.probe_ms()
    counters = drv.counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    gc.collect()

    numbers = drv.check()
    limits = r["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    ctx = {"cell": r["cell"], "config": r["config"], "traffic": r["traffic"],
           "window_s": window_s, "counters": counters, "work": drv.work(), "trace": None}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if trace:
        tr = profiling.Trace(prof)
        if tr.busy_s > window_s:
            raise RuntimeError(f"the trace's busy seconds {tr.busy_s!r} exceed the window's "
                               f"{window_s!r}: its intervals reach outside the window")
        ctx["trace"] = tr
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = window_s
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
        wanted = r["per_layer"]
    else:
        ctx["setup_s"] = setup_s
        wanted = r["end_to_end"]
    for m in wanted:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(counters["units"]), "failed": 0,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    print(f"host: {json.dumps(host_info)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}"
              f" {'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    r = resolve(args.workload)
    card = host.card()
    pin = host.Pinning(host.local_cores(card.get("pci.bus_id", "")))
    pin.start()  # before numpy and torch start their threads
    probe_before = host.probe_ms()

    import torch

    torch.set_num_threads(HOST_THREADS)
    chips = int(r["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cxlbench: {args.workload} needs {chips} CUDA card(s), this machine has {have}; "
              "the benchmark measures only on the card and never falls back to the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    line = (f"{card.get('name', 'nvidia-smi unavailable')}, {card.get('power.limit', '?')}; "
            f"count {torch.cuda.device_count()}")
    print(f"cxlbench: card {line}; workload {args.workload} seed {args.seed} "
          f"seconds {args.seconds} trace {args.trace}; host cores {pin.cores}, "
          f"probe {probe_before!r} ms", file=sys.stderr, flush=True)
    print(f"card: {line}; cards used: {chips}", flush=True)
    out = run_cell(r, args.seed, args.seconds, bool(args.trace), "cuda", pin=pin)
    bad = forbidden_modules()
    if bad:
        print(f"cxlbench: the process holds {bad} (jax, jaxlib, flax or the JAX package)",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
