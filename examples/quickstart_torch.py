"""Quickstart, on the PyTorch port: simulate a CXL.mem topology for a
training step (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain PyTorch

Without a card and without ``--device cpu`` it raises, as every entry
point of ``repro_torch`` does.
"""

import argparse
import dataclasses

import torch

import repro_torch.configs as cfgs
from repro_torch.core import (
    H100_SXM,
    CXLMemSim,
    ClassMapPolicy,
    EpochSchedule,
    figure1_topology,
)
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models.phases import build_regions_and_phases
from repro_torch.optim.adamw import AdamWConfig, adamw_init

BATCH, SEQ, STEPS = 8, 128, 5

# 1. pick an architecture from the zoo (reduced config, f32 compute)
CFG = dataclasses.replace(cfgs.get_smoke("qwen3-0.6b"), dtype=torch.float32)


def run(device="cuda", hw=H100_SXM, steps=STEPS, params=None, batch=None):
    """``steps`` attached train steps; returns the topology, the losses and
    the ``SimReport``.  ``params`` (a :class:`Model` on ``device``) and
    ``batch`` default to weights from seed 0 and tokens and labels from
    seeded ``torch.Generator``s."""
    device = resolve_device(device)  # raises without a card, unless "cpu"
    # 2. a real train step: the loss, its backward pass and AdamW, in place
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=100)
    if params is None:
        params = Model(CFG, device=device, seed=0)
    opt_state = {"adam": adamw_init(params, opt_cfg), "ef": {}}
    step = make_train_step(CFG, opt_cfg, device=device)

    # 3. the memory topology (paper Figure 1) and a placement policy:
    #    optimizer state lives in a far CXL pool behind two switches
    topo = figure1_topology()
    policy = ClassMapPolicy({"opt_state": "cxl_pool2"})

    # 4. attach CXLMemSim: the tracer registers every tensor region
    regions, phases = build_regions_and_phases(CFG, "train", batch=BATCH, seq=SEQ)
    sim = CXLMemSim(topo, policy, epoch=EpochSchedule("layer"), hw=hw, check_capacity=False,
                    device=device)

    # 5. run real steps; the analyzer prices every epoch against the topology
    if batch is None:
        batch = {}
        for key, seed in (("tokens", 1), ("labels", 2)):
            gen = torch.Generator(device=device).manual_seed(seed)
            batch[key] = torch.randint(0, CFG.vocab_size, (BATCH, SEQ), generator=gen,
                                       device=device)
    losses = []
    with sim.attach(step, phases, regions) as prog:
        for _ in range(steps):
            params, opt_state, metrics = prog.step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
        report = prog.report  # folds the analyses still in flight
    return {"topology": topo, "losses": losses, "report": report}


def report_lines(out):
    """The lines ``examples/quickstart.py`` prints, for ``run``'s result."""
    topo, r = out["topology"], out["report"]
    lines = [topo.describe()]
    lines += [f"step {i}: loss={loss:.3f}" for i, loss in enumerate(out["losses"])]
    lines += [
        f"\nnative      {r.native_s*1e3:.1f} ms",
        f"simulated   {r.simulated_s*1e3:.1f} ms  (slowdown {r.slowdown:.2f}x)",
        f"delays      latency {r.latency_s*1e3:.2f} ms | congestion "
        f"{r.congestion_s*1e3:.2f} ms | bandwidth {r.bandwidth_s*1e3:.2f} ms",
        "per-pool latency (ns): "
        + str(dict(zip(topo.flatten().pool_names, r.per_pool_latency_ns))),
    ]
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    print("\n".join(report_lines(run(device=args.device))))


if __name__ == "__main__":
    main()
