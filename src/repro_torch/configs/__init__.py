from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    DetectorConfig,
    LMConfig,
    ShapeSpec,
    get_config,
    reduced,
)
