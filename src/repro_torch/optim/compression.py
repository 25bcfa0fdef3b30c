"""int8 gradient compression with error feedback (port of
``repro/optim/compression.py``).

Each tensor is quantized symmetrically to int8 at the scale ``max|x| /
127`` (plus 1e-12), rounding half to even as ``jnp.round`` does, and the
quantization error is carried to the next step.  In the reference this
runs before the data-parallel all-reduce so that it moves int8; on one
card there is no all-reduce, and compression only changes the gradients
the optimizer sees, exactly as the reference's step does.  Trees are
mappings of the port's parameter names to tensors; a scale is the
reference's, one per reference leaf, so the ``blocks.{g}.*`` tensors of
one stacked leaf share theirs (:func:`repro_torch.interop.reference_leaves`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..interop import _named, reference_leaves

__all__ = ["compress_tree", "decompress_tree", "ef_compress", "init_error_state"]

Named = Mapping[str, torch.Tensor]


def _scale(xs) -> torch.Tensor:
    """One reference leaf's scale over its tensors ``xs`` (f32)."""
    return torch.stack([x.abs().max() for x in xs]).max() / 127.0 + 1e-12


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree: Named) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{'q': int8 tensors, 'scale': f32 scalars}``, keyed as ``tree``."""
    q, scales = {}, {}
    for leaf in reference_leaves(tree):
        xs = [tree[k].float() for k in leaf]
        s = _scale(xs)
        for k, x in zip(leaf, xs):
            q[k], scales[k] = _quant(x, s), s
    return {"q": q, "scale": scales}


def decompress_tree(packed) -> Dict[str, torch.Tensor]:
    return {k: _dequant(q, packed["scale"][k]) for k, q in packed["q"].items()}


def init_error_state(params) -> Dict[str, torch.Tensor]:
    """Zero f32 residuals beside each tensor of ``params`` (a mapping or a
    module's parameters)."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in _named(params).items()}


def ef_compress(grads: Named, err_state: Named):
    """Error-feedback compression: ``(dequantized grads, new residual)``,
    ``g' = Q(g + e)``, ``e' = (g + e) - g'``."""
    out, err = {}, {}
    for leaf in reference_leaves(grads):
        xs = [grads[k].float() + err_state[k] for k in leaf]
        s = _scale(xs)
        for k, x in zip(leaf, xs):
            deq = _dequant(_quant(x, s), s)
            out[k], err[k] = deq.to(grads[k].dtype), x - deq
    return out, err
