"""ssd mobilenetv2 analogue (Table II row 3): small input (300x300->
we use 288 to keep stride alignment), narrow trunk [SSD arXiv:1512.02325,
MobileNetV2 arXiv:1801.04381; the paper's Table II]."""
from repro_torch.configs.base import DetectorConfig

CONFIG = DetectorConfig(
    name="ssd-mobilenetv2",
    input_size=288,
    widths=(16, 24, 48, 96, 160),
    n_blocks_per_stage=1,
)
