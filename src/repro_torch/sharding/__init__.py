from repro_torch.sharding.api import (ShardingContext, current_context, shard,
                                      use_sharding)
from repro_torch.sharding.rules import (DEFAULT_RULES, FSDP_RULES,
                                        distribute_params, expert_axes,
                                        param_shardings, spec_for_param)

__all__ = ["ShardingContext", "current_context", "shard", "use_sharding",
           "DEFAULT_RULES", "FSDP_RULES", "distribute_params", "expert_axes",
           "param_shardings", "spec_for_param"]
