"""resnet-152 [vision] — img_res=224 depths=3-8-36-3 width=64
bottleneck=1 [arXiv:1512.03385; paper]."""
from repro_torch.configs.base import VisionConfig

CONFIG = VisionConfig(
    name="resnet-152",
    kind="resnet",
    img_res=224,
    depths=(3, 8, 36, 3),
    width=64,
)
