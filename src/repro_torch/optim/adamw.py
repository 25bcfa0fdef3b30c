"""AdamW over named tensors (port of ``repro/optim/adamw.py``).

The reference updates pytrees and returns new ones; here parameters, their
gradients and the moments are mappings of the port's parameter names to
tensors (a :class:`~repro_torch.models.model.Model` stands for its
``named_parameters()``), and the update writes parameters and moments in
place under ``torch.no_grad()``.  The arithmetic is the reference's, in
its order: ``lr``, the bias corrections and the clip scale are f32
scalars on the parameters' device, every update runs in f32 and rounds
once into the parameter's dtype, and the moments are stored in
``moment_dtype``.  The global norm adds the leaves' sums in the
reference's leaf order (``jax.tree.leaves``: sorted keys), a stacked
``blocks`` leaf as the sum of its groups' sums in group order.

The state is ``{'mu': {name: tensor}, 'nu': {name: tensor}, 'step': int32
scalar}``; :func:`repro_torch.interop.adamw_state_to_arrays` gives the
reference's tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

from ..interop import _named, reference_leaves

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
]

Named = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr_ratio * lr`` at ``total_steps``; f32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm over every tensor of ``tree``."""
    named = _named(tree)
    total = 0
    for leaf in reference_leaves(named):
        total = total + sum(named[n].float().square().sum() for n in leaf)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled by min(1, max_norm / norm), norm)``, each tensor
    scaled in f32 and rounded back into its dtype."""
    named = _named(tree)
    n = global_norm(named)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in named.items()}, n


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, step 0."""
    named = _named(params)

    def zeros():
        return {k: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
                for k, p in named.items()}

    dev = next(iter(named.values())).device
    return {"mu": zeros(), "nu": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(
    params, grads: Named, state: Dict[str, Any], cfg: AdamWConfig
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: returns ``(params, new_state, {'lr',
    'grad_norm'})``; the new state holds the same moment tensors, updated,
    and the next step count."""
    named = _named(params)
    with torch.no_grad():
        step = state["step"] + 1
        lr = cosine_schedule(cfg, step)
        if cfg.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            gnorm = global_norm(grads)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        for name, p in named.items():
            mu, nu = state["mu"][name], state["nu"][name]
            g32 = grads[name].float()
            mu32 = mu.float() * b1 + (1 - b1) * g32
            nu32 = nu.float() * b2 + (1 - b2) * g32.square()
            mhat = mu32 / bc1
            vhat = nu32 / bc2
            p32 = p.float()
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
            p.copy_(p32 - lr * delta)
            mu.copy_(mu32)
            nu.copy_(nu32)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, {
        "lr": lr, "grad_norm": gnorm}
