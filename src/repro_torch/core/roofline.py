"""Roofline terms of a step (port of ``repro/core/roofline.py``'s
``RooflineTerms`` and ``roofline_terms``).

Three terms per step, each a lower bound on its time on one device:

    compute_s    = FLOPs / peak FLOP/s
    memory_s     = bytes / HBM bandwidth
    collective_s = collective bytes / link bandwidth

under a :class:`~repro_torch.core.tracer.HardwareModel` (the port's default
``H100_SXM``; the reference's is ``TPU_V5E``).  The inputs are per-device
quantities; where they come from is the caller's choice.  The reference
also parses collective bytes from XLA HLO text
(``collective_bytes_from_hlo``), which has no PyTorch counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .tracer import H100_SXM, HardwareModel
from .units import gbps_to_bytes_per_s

__all__ = ["RooflineTerms", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float  # 6·N·D (train) or 2·N·tokens (inference), per device
    n_chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline lower bound on step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over executed FLOPs: catches remat and redundant
        compute."""
        return self.model_flops / self.hlo_flops if self.hlo_flops > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the roofline bound: (model FLOPs / peak)
        / max(compute, memory, collective), how close the step would run to
        ideal hardware speed if it achieved its bound."""
        if self.bound_s <= 0:
            return 0.0
        ideal = self.model_flops / (self.hlo_flops / max(self.compute_s, 1e-30))
        return ideal / self.bound_s

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
        }


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    model_flops: float,
    n_chips: int,
    hw: HardwareModel = H100_SXM,
) -> RooflineTerms:
    """All inputs are per-device quantities (the reference's names: FLOPs
    and bytes of the compiled per-device program)."""
    return RooflineTerms(
        compute_s=hlo_flops / hw.peak_flops,
        memory_s=hlo_bytes / gbps_to_bytes_per_s(hw.hbm_gbps),
        collective_s=collective_bytes / gbps_to_bytes_per_s(hw.ici_gbps),
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops,
        n_chips=n_chips,
    )
