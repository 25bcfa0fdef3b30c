"""Read a cell's control, and the program's own readings, through the
harness's own run: the control (the traffic kind's ``Control``: the plain
reference one precision below what the configuration states) is put in
the program's place, and ``run.run_cell`` checks it against the reference
and the cell's limits as it checks a run.  The control has to come out not
correct on every seed; the benchmark's own runs never run this.

    python3 -m cxlbench.control --workload <cell> --seeds 11 12 13 [--units 16]
                                [--program-seeds 21 22 ... --program-units 4]

prints, for each seed, the control's numbers with their limits and
``correct``, and with ``--program-seeds`` the program's numbers over a
short window of ``--program-units`` units a seed, all in one process (the
lower readings of the limits).  The starcoder2 prefill's needs the card."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import run


def read(r: dict, seed: int, device, units: int, control: bool = True) -> dict:
    """One run of the cell's control (or, with ``control=False``, of the
    program) over ``units`` units: the run's result dict."""
    drv = run.driver_module(r["traffic"]["kind"])
    return run.run_cell(r, seed, 0.0, False, device, units=units,
                        driver=drv.Control if control else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=16)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-units", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run._fixed_caches()
    sys.path.insert(0, str(run.ROOT / "src"))
    r = run.resolve(args.workload)
    runs = [(s, True, args.units) for s in args.seeds]
    runs += [(s, False, args.program_units) for s in args.program_seeds]
    control_failed = True
    for seed, control, units in runs:
        t0 = time.perf_counter()
        out = read(r, seed, args.device, units, control)
        gc.collect()
        if control:
            control_failed &= not out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control" if control else "program", "units": units,
                          "correct": out["correct"], "checks": out["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(f"control of {args.workload}: "
          f"{'not correct on every seed' if control_failed else 'CORRECT on some seed'}",
          flush=True)
    return 0 if control_failed else 1


if __name__ == "__main__":
    sys.exit(main())
