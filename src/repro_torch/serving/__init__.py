from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request, Response

__all__ = ["EngineConfig", "ServingEngine", "Request", "Response"]
