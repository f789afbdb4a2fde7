from repro_torch.configs.base import (  # noqa: F401
    DetectorConfig,
    get_config,
    reduced,
)
