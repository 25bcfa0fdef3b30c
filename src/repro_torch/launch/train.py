"""The training driver (port of ``repro/launch/train.py``).

Composes the model, AdamW, the synthetic pipeline, the checkpoint manager
and, with ``simulate``, CXLMemSim attached to the train step (the
``"train"`` memory program on ``two_tier_topology()`` with the optimizer
state in ``cxl_pool``, step epochs).  On the card the step runs there; with
``device="cpu"`` it runs the plain versions.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
        --steps 20 --batch 8 --seq 128 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from .. import configs as cfgs
from ..checkpoint.manager import CheckpointManager, FaultToleranceConfig
from ..core import CXLMemSim, ClassMapPolicy, EpochSchedule, two_tier_topology
from ..core.analyzer import _check_device
from ..data.pipeline import SyntheticPipeline
from ..models import Model, ModelConfig
from ..models.phases import build_regions_and_phases
from ..optim.adamw import AdamWConfig, adamw_init
from .steps import make_train_step

__all__ = ["main", "train_loop"]


def train_loop(
    cfg: ModelConfig,
    steps: int = 20,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_interval: int = 10,
    simulate: bool = False,
    topology=None,
    policy=None,
    seed: int = 0,
    log_every: int = 5,
    device="cuda",
) -> Dict[str, Any]:
    """Train ``steps`` steps from a fresh model (weights from ``seed``) or
    from the newest checkpoint in ``ckpt_dir``; returns the losses, the step
    count, wall seconds, the final loss, the first step, and with
    ``simulate`` the simulator's summary, with ``ckpt_dir`` the straggler
    events."""
    dev = _check_device(device)
    opt_cfg = AdamWConfig(lr=lr, total_steps=max(steps, 2), warmup_steps=max(steps // 10, 1))
    step_fn = make_train_step(cfg, opt_cfg, device=dev)

    def init_fn():
        model = Model(cfg, device=dev, seed=seed)
        return {"params": model, "opt": {"adam": adamw_init(model, opt_cfg), "ef": {}}}

    manager = None
    start_step = 0
    if ckpt_dir:
        manager = CheckpointManager(
            FaultToleranceConfig(directory=ckpt_dir, interval_steps=ckpt_interval)
        )
        state, start_step = manager.resume_or_init(init_fn)
    else:
        state = init_fn()
    params, opt_state = state["params"], state["opt"]

    pipe = SyntheticPipeline(cfg, batch, seq, seed=seed, device=dev)

    attached = None
    if simulate:
        topology = topology or two_tier_topology()
        policy = policy or ClassMapPolicy({"opt_state": "cxl_pool"})
        regions, phases = build_regions_and_phases(cfg, "train", batch, seq)
        sim = CXLMemSim(topology, policy, epoch=EpochSchedule("step"), check_capacity=False,
                        device=dev)
        attached = sim.attach(step_fn, phases, regions)

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch_data = pipe.device_batch(step)
        ts = time.time()
        if attached is not None:
            params, opt_state, metrics = attached.step(params, opt_state, batch_data)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        loss = float(metrics["loss"])  # waits for the step
        dur = time.time() - ts
        losses.append(loss)
        if manager is not None:
            manager.observe_step(step, dur)
            manager.maybe_save(step, {"params": params, "opt": opt_state})
        if log_every and step % log_every == 0:
            print(
                f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                f"({dur:.2f}s)",
                flush=True,
            )
    out = {
        "losses": losses,
        "steps": steps - start_step,
        "wall_s": time.time() - t0,
        "final_loss": losses[-1] if losses else float("nan"),
        "start_step": start_step,
    }
    if attached is not None:
        out["sim"] = attached.report.summary()
    if manager is not None:
        out["stragglers"] = manager.straggler_events
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--simulate", action="store_true", help="attach CXLMemSim")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    cfg = cfgs.get_smoke(args.arch) if args.smoke else cfgs.get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)  # f32 compute, as the reference's driver
    out = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        ckpt_dir=args.ckpt_dir, simulate=args.simulate, device=args.device,
    )
    print({k: v for k, v in out.items() if k != "losses"})


if __name__ == "__main__":
    main()
