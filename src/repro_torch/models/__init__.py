"""Model descriptions the simulator reads: configs and memory programs."""

from .config import ModelConfig
from .phases import build_regions_and_phases, group_param_bytes

__all__ = ["ModelConfig", "build_regions_and_phases", "group_param_bytes"]
