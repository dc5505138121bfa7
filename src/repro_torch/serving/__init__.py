from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.faults import (FaultError, FaultInjector, FaultPlan,
                                        HealthMonitor, InjectedFault)
from repro_torch.serving.request import Request, Response
from repro_torch.serving.server import AsyncServingServer

__all__ = ["EngineConfig", "ServingEngine", "AsyncServingServer", "Request",
           "Response", "FaultPlan", "FaultInjector", "FaultError",
           "HealthMonitor", "InjectedFault"]
