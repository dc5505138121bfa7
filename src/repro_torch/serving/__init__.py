from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.faults import (FaultError, FaultInjector, FaultPlan,
                                        HealthMonitor, InjectedFault)
from repro_torch.serving.request import Request, Response
from repro_torch.serving.server import AsyncServingServer
from repro_torch.serving.sharded import ShardedServingEngine

__all__ = ["EngineConfig", "ServingEngine", "ShardedServingEngine",
           "AsyncServingServer", "Request",
           "Response", "FaultPlan", "FaultInjector", "FaultError",
           "HealthMonitor", "InjectedFault"]
