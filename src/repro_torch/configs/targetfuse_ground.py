"""The paper's ground-tier counter: a YOLOv3-class detector (416x416,
deeper/wider trunk -> higher mAP). Table II row 1."""
from repro_torch.configs.base import DetectorConfig

CONFIG = DetectorConfig(
    name="targetfuse-ground",
    input_size=416,
    widths=(32, 64, 128, 256, 512, 1024),
    n_blocks_per_stage=2,
)
