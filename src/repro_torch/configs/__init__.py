from repro_torch.configs.base import (  # noqa: F401
    ARCHS, SHAPES, ModelConfig, MoEConfig, SSMConfig, ShapeConfig,
    all_cells, get_config, get_shape, reduced,
)
