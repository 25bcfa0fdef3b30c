"""Model descriptions the simulator reads (configs and memory programs) and
the model zoo's forward passes (every family: dense, moe, hybrid, ssm, vlm
and audio)."""

from .config import ModelConfig
from .model import Model
from .phases import build_regions_and_phases, group_param_bytes

__all__ = ["Model", "ModelConfig", "build_regions_and_phases", "group_param_bytes"]
