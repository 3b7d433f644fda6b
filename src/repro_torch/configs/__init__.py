"""Model configurations of the port (plain data, no torch)."""

from .base import (  # noqa: F401
    SHAPE_GRID,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_config,
    list_configs,
    reduce_config,
    register,
)
