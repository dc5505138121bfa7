from repro_torch.models.config import ModelConfig, repeat_pattern
from repro_torch.models.model import Model

__all__ = ["ModelConfig", "Model", "repeat_pattern"]
