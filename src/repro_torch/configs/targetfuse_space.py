"""The paper's onboard (space-tier) counter: a YOLOv3-tiny-class
single-shot detector (416x416 input, shallow trunk). Table II row 2."""
from repro_torch.configs.base import DetectorConfig

# 6 stride-2 stages -> 13x13 grid at 416 px, ~6 GFLOP/tile forward --
# matching YOLOv3-tiny's published compute (5.6 GFLOPs @416).
CONFIG = DetectorConfig(
    name="targetfuse-space",
    input_size=416,
    widths=(16, 32, 64, 128, 256, 512),
    n_blocks_per_stage=2,
)
