from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    all_configs,
    get_config,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "all_configs",
    "get_config",
    "shape_applicable",
]
