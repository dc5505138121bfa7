from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = ["ARCH_IDS", "all_configs", "get_config"]
