"""Model descriptions the simulator reads (configs and memory programs) and
the model zoo's forward passes (the dense, moe, hybrid and ssm families so
far)."""

from .config import ModelConfig
from .model import Model
from .phases import build_regions_and_phases, group_param_bytes

__all__ = ["Model", "ModelConfig", "build_regions_and_phases", "group_param_bytes"]
