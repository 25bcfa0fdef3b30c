"""End-to-end training on the PyTorch port (the counterpart of
``examples/train_100m.py``): train a ~100M-param model for a few hundred
steps with the full production stack — data pipeline, AdamW, periodic
checkpoints, restart-on-resume, straggler watch, and CXLMemSim attached.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 200] [--device cpu]

The model is a 12-layer/640-dim dense GQA transformer (~100M params with the
qwen3 tokenizer's vocab scaled down), trained on the synthetic pipeline in
f32 on the card.  Interrupt it and re-run: it resumes from the newest
committed checkpoint.  The default checkpoint directory is the port's own,
apart from ``examples/train_100m.py``'s, so neither resumes the other's run.
"""

import argparse
import os
import tempfile

import torch

from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models import ModelConfig

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt")

CONFIG = ModelConfig(
    name="dense-100m",
    family="dense",
    n_layers=12,
    d_model=640,
    n_heads=10,
    n_kv_heads=2,
    d_head=64,
    d_ff=2560,
    vocab_size=32768,
    rope_variant="rope",
    dtype=torch.float32,
    cache_dtype=torch.float32,
    remat=False,  # small model: no need
)


def run(device="cuda", cfg=CONFIG, steps=200, batch=8, seq=256, ckpt_dir=CKPT_DIR,
        log_every=10):
    """``train_loop``'s summary for ``cfg`` (from step 0, or from the newest
    checkpoint in ``ckpt_dir``), with ``params``, the model's parameter
    count."""
    device = resolve_device(device)  # raises without a card, unless "cpu"
    out = train_loop(
        cfg,
        steps=steps,
        batch=batch,
        seq=seq,
        lr=3e-4,
        ckpt_dir=ckpt_dir,
        ckpt_interval=50,
        simulate=True,  # CXLMemSim attached: optimizer state in a CXL pool
        log_every=log_every,
        device=device,
    )
    out["params"] = cfg.param_counts()["total"]
    return out


def report_lines(out):
    """The lines ``examples/train_100m.py`` prints after training."""
    lines = [f"\nfinal loss {out['final_loss']:.4f} after {out['steps']} steps "
             f"({out['wall_s']:.0f}s wall, resumed from step {out['start_step']})"]
    if out["losses"]:  # a run resumed past its last step trains none
        first, last = out["losses"][0], out["final_loss"]
        lines.append(f"loss moved {first:.3f} -> {last:.3f} "
                     f"({'OK: decreasing' if last < first else 'WARN'})")
    if "sim" in out:
        s = out["sim"]
        lines.append(
            f"CXLMemSim: simulated slowdown {s['slowdown']:.3f}x "
            f"(latency {s['latency_s']:.3f}s, bandwidth {s['bandwidth_s']:.3f}s "
            f"over {s['epochs']} epochs)"
        )
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    print(f"params: {CONFIG.param_counts()['total']/1e6:.1f}M")
    out = run(device=args.device, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir)
    print("\n".join(report_lines(out)))


if __name__ == "__main__":
    main()
