from repro_torch.configs.base import (
    ARCH_IDS,
    ModelConfig,
    MoEConfig,
    all_configs,
    get_config,
)

__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "MoEConfig",
    "all_configs",
    "get_config",
]
